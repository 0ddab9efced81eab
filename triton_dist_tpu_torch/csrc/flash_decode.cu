// K2 · flash decode and K3 · paged flash decode: one query token per
// sequence attends its KV cache with grouped-query heads, returning
// (out f32 [b, hq, d], lse f32 [b, hq]). K38 · quantized decode and K39 ·
// its paged twin: the same kernel over a one-byte cache (int8 or fp8 e4m3)
// with f32 row scales per (sequence or page, kv head, position).
//
// Replaces triton_dist_tpu/ops/flash_decode.py:284 _flash_decode_kernel
// (K2; also :340 _flash_decode_fused_heads_kernel, the same function on a
// TPU grid with the kv-head loop inside the body) and :1414
// _paged_flash_decode_kernel (K3). The math is that of
// _online_softmax_step (:195) and _finalize_softmax (:242): scale by
// 1/sqrt(true head dim), the optional soft cap before the length mask,
// m_safe = max(m, -1e30) so a fully masked row never computes inf - inf,
// and kv_len == 0 gives out = 0, lse = -inf. The span merge is the algebra
// of combine_partials (:1852).
//
// What bounds it on the H100: decode reads every cached K and V element
// once and does 4 FLOPs per element and query head — about 2g FLOPs per
// byte of a bf16 cache, far below the ~295 FLOP/byte ridge, so it is bound
// by memory bandwidth.
//
// What the design does about it: the TPU kernel walks KV chunks in
// sequence with the softmax carry in VMEM; Hopper has no sequential grid
// carry, and one block per (sequence, kv head) is only 64 blocks at batch 8
// with 8 kv heads on 132 SMs. So the sequence is split (split-KV): each
// block owns one (sequence, kv head, KV span), stages 64-row K and V tiles
// in shared memory with 16-byte cp.async loads (each row read once for all
// g query heads of its group), and keeps the online-softmax carry in
// shared memory and registers. A second small kernel merges the spans'
// (out, lse) pairs. The wrapper picks the span count so the grid holds
// about four blocks per SM, enough bytes in flight to cover memory
// latency; a span that starts past its sequence's length exits without
// reading. The paged kernel finds each row through the block table and
// touches only pages below ceil(kv_len / page). Rows are padded in shared
// memory to the power-of-two head dim (_kernel_head_dim), zero past d.
//
// K3 on a bf16 page pool and K2 on a bf16 contiguous cache run a second
// kernel, onepass_kernel (one launch a call): the split kernel's two
// launches, spans sized from the cache's width (most blocks of a short
// sequence exit, a few walk long spans) and its row-by-row cp.async staging
// with no overlap of loads and math left it 2.5-2.8x off SDPA at the served
// shapes. Each block owns one (sequence, kv head, span) where the spans cut
// the sequence's OWN length, read from kv_lens on the device: span_pages
// pages each (a multiple of the 64-position tile), so the longest sequence
// has the most blocks and every block walks at most span_pages pages; the
// grid's span count comes from max_pages, a bound the host knows, so the
// step never reads the lengths on the host. A page of one kv head is one
// contiguous [page, d] slab, and a contiguous cache is read as "pages" of
// one 64-position tile (its tile is one contiguous [nt, d] run, clipped at
// the sequence's length): thread 0 fetches each with cp.async.bulk (K and
// V, completing on the tile's mbarrier), two tiles in flight. Scores split
// each row over 8 threads (16-byte shared loads, conflict-free on the
// unpadded slab rows); P.V gives each thread one or two head-dim columns. A
// span writes its (out, lse) partial; the last block of a (sequence, kv
// head) to arrive, found with an arrival counter behind a fence, merges the
// partials in span order (the result does not depend on arrival order).
// The wrapper zeroes the counters in the call's stream, so a captured graph
// replays that memset with the launch. A sequence with one span writes the
// output directly; kv_len == 0 writes out 0, lse -inf. The math contract
// above is unchanged. Caches of another dtype, head dims not a multiple of
// 8 or over 256, and pages that do not divide 64 stay on the split kernel
// (ops/flash_decode.py::_decode_engine).
//
// K38/K39 replace :1231 _flash_decode_quant_kernel (body _flash_decode_body
// :250 with row scales), :350 _flash_decode_fused_heads_quant_kernel (the
// same function with the kv-head loop inside the TPU body: this grid reads
// each row once for all heads of its group either way) and :1414
// _paged_flash_decode_kernel(quant=True). The quantized contract of
// _online_softmax_step (:195-239): q arrives in bf16, the one-byte payload
// rises to f32 exactly (every int8 and e4m3 value is a bf16 value), each
// score column is multiplied by (k_scale[pos] * scale), l sums the unrounded
// probabilities, and P.V takes (p * v_scale[pos]) rounded to bf16. The
// payload rides the same 16-byte cp.async copies (16 values a copy, so a
// row needs d % 16 == 0 for them; other head dims load value by value); a
// tile's 64 k and v scales are staged beside it, found through the block
// table like their rows (the scale pool is the payload pool with d = 1).
// What bounds it: the bytes, 2 * (d + 4) a cached position and kv head
// against 4 * d for bf16 — the reason a one-byte cache exists.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };
typedef __nv_bfloat16 bf16;
typedef __nv_fp8_e4m3 fp8;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;   // cache rows per online-softmax step
constexpr int MAX_G = 16;  // query heads per kv head
constexpr int HALF_G = MAX_G / 2;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) { return (float)x; }
template <> __device__ __forceinline__ float to_f32<fp8>(fp8 x) { return (float)x; }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }
template <> __device__ __forceinline__ int8_t zero<int8_t>() { return 0; }
template <> __device__ __forceinline__ fp8 zero<fp8>() { return fp8(0.f); }

// The dtype the kernel reads q in: the cache's own, bf16 for a one-byte cache.
template <typename T> struct QOf { typedef T type; };
template <> struct QOf<int8_t> { typedef bf16 type; };
template <> struct QOf<fp8> { typedef bf16 type; };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One 16-byte shared-memory chunk (8 bf16 or 4 f32) as floats.
__device__ __forceinline__ void load_chunk_f32(const bf16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_chunk_f32(const float* p, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

// One 16-byte chunk of 16 one-byte values as floats (exact).
__device__ __forceinline__ void load_chunk_f32(const int8_t* p, float* out) {
  const int4 u = *reinterpret_cast<const int4*>(p);
  const int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = (float)(int8_t)(w[i / 4] >> (8 * (i % 4)));
}
__device__ __forceinline__ void load_chunk_f32(const fp8* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_fp8x2_e4m3* f2 = reinterpret_cast<const __nv_fp8x2_e4m3*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 f = static_cast<float2>(f2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Element offset of cache row (sequence bi, kv head h, position pos).
// Contiguous cache [b, h_kv, s_len, d]; paged pool [n_pages, h_kv, page, d]
// with block_table [b, max_pages].
template <bool PAGED>
__device__ __forceinline__ int64_t row_offset(int bi, int h, int pos, int h_kv,
                                              int s_len, int page, int max_pages,
                                              const int* __restrict__ table,
                                              int d) {
  if (PAGED) {
    const int pid = table[(int64_t)bi * max_pages + pos / page];
    return (((int64_t)pid * h_kv + h) * page + pos % page) * d;
  }
  return (((int64_t)bi * h_kv + h) * s_len + pos) * d;
}

// Stage cache rows [t0, t0 + nt) of one (sequence, kv head) into shared
// memory rows of `ld` elements, zero past the head dim d (up to dp). With
// `vec` (d a multiple of a 16-byte chunk, aligned base) whole chunks ride
// cp.async; otherwise each element is loaded with its own check.
template <typename T, bool PAGED>
__device__ __forceinline__ void stage_rows(
    T* dst, int ld, const T* __restrict__ src, int bi, int h, int t0, int nt,
    int h_kv, int s_len, int page, int max_pages, const int* __restrict__ table,
    int d, int dp, bool vec) {
  constexpr int E = 16 / sizeof(T);
  const int cpr = dp / E;
  for (int e = threadIdx.x; e < nt * cpr; e += THREADS) {
    const int p = e / cpr, c = (e % cpr) * E;
    T* out = dst + p * ld + c;
    const T* row = src + row_offset<PAGED>(bi, h, t0 + p, h_kv, s_len, page,
                                           max_pages, table, d);
    if (vec && c < d) {
      cp_async16(out, row + c);
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) out[i] = c + i < d ? row[c + i] : zero<T>();
    }
  }
}

// One block per (sequence, kv head, KV span), 128 threads. Per 64-row tile:
// K and V rows land in shared memory (16-byte cp.async); each thread scores
// one (row, half of the query heads) pair against q held in shared memory;
// one warp per query head updates its (m, l); each thread then owns two
// head-dim columns of the P.V accumulator for every query head. A one-byte
// T (K38/K39) also stages the tile's row scales and folds them in.
template <typename T, bool PAGED>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(
    const typename QOf<T>::type* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_lens, const int* __restrict__ table,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    float* __restrict__ out_part, float* __restrict__ lse_part, int b, int hq,
    int h_kv, int d, int dp, int s_len, int page, int max_pages, int chunk,
    float scale, float soft_cap, int vec) {
  constexpr bool QUANT = sizeof(T) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = hq / h_kv;
  const int ld = dp + 16 / (int)sizeof(T);  // +16 bytes staggers banks
  float* q_s = reinterpret_cast<float*>(smem);  // [g][dp]
  float* p_s = q_s + g * dp;                     // [g][TILE]
  float* m_s = p_s + g * TILE;                   // [g]
  float* l_s = m_s + g;
  float* alpha_s = l_s + g;
  float* ks_s = alpha_s + g;                     // [TILE] (QUANT)
  float* vs_s = ks_s + TILE;                     // [TILE] (QUANT)
  const int n_f32 = g * (dp + TILE + 3) + (QUANT ? 2 * TILE : 0);
  T* k_s = reinterpret_cast<T*>(smem + (((size_t)n_f32 * sizeof(float) + 15) / 16) * 16);
  T* v_s = k_s + TILE * ld;

  const int bi = blockIdx.x / h_kv, h = blockIdx.x % h_kv, split = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kv_len = min(kv_lens[bi], s_len);
  const int start = split * chunk;
  const int end = min(start + chunk, kv_len);
  // this block's g output rows in the [splits, b, hq] partials
  const int64_t row0 = ((int64_t)split * b + bi) * hq + (int64_t)h * g;

  if (start >= end) {  // empty span: out 0, lse -inf (weight 0 in the merge)
    for (int e = threadIdx.x; e < g * d; e += THREADS) out_part[row0 * d + e] = 0.f;
    if (threadIdx.x < g) lse_part[row0 + threadIdx.x] = -INFINITY;
    return;
  }

  const typename QOf<T>::type* qb = q + ((int64_t)bi * hq + (int64_t)h * g) * d;
  for (int e = threadIdx.x; e < g * dp; e += THREADS) {
    const int j = e / dp, dd = e % dp;
    q_s[e] = dd < d ? to_f32(qb[(int64_t)j * d + dd]) : 0.f;
  }
  if (threadIdx.x < g) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }
  float acc[MAX_G][2];
#pragma unroll
  for (int j = 0; j < MAX_G; ++j) acc[j][0] = acc[j][1] = 0.f;
  const int c0 = 2 * threadIdx.x;  // this thread's two head-dim columns
  const int p_own = threadIdx.x % TILE, half = threadIdx.x / TILE;

  for (int t0 = start; t0 < end; t0 += TILE) {
    const int nt = min(TILE, end - t0);
    stage_rows<T, PAGED>(k_s, ld, k, bi, h, t0, nt, h_kv, s_len, page, max_pages,
                         table, d, dp, vec);
    stage_rows<T, PAGED>(v_s, ld, v, bi, h, t0, nt, h_kv, s_len, page, max_pages,
                         table, d, dp, vec);
    if (QUANT && threadIdx.x < TILE) {  // the scale rows are the pool with d = 1
      const int p = threadIdx.x;
      const int64_t o = p < nt ? row_offset<PAGED>(bi, h, t0 + p, h_kv, s_len, page,
                                                   max_pages, table, 1) : 0;
      ks_s[p] = p < nt ? k_scale[o] : 0.f;  // 0 past the span: p = 0 meets a finite 0
      vs_s[p] = p < nt ? v_scale[o] : 0.f;
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
    __syncthreads();

    // (a) scores of row p_own against query heads half, half + 2, ...
    {
      float s[HALF_G];
#pragma unroll
      for (int i = 0; i < HALF_G; ++i) s[i] = 0.f;
      if (p_own < nt) {
        constexpr int E = 16 / sizeof(T);
        const T* kr = k_s + p_own * ld;
        for (int c = 0; c < dp; c += E) {
          float kf[E];
          load_chunk_f32(kr + c, kf);
#pragma unroll
          for (int i = 0; i < HALF_G; ++i) {
            const int j = half + 2 * i;
            if (j < g) {
              const float* qj = q_s + j * dp + c;
#pragma unroll
              for (int e = 0; e < E; ++e) s[i] = fmaf(qj[e], kf[e], s[i]);
            }
          }
        }
      }
      // the reference's order: dot * (k_scale * scale)
      const float col_scale = QUANT ? ks_s[p_own] * scale : scale;
#pragma unroll
      for (int i = 0; i < HALF_G; ++i) {
        const int j = half + 2 * i;
        if (j < g) {
          float sc = s[i] * col_scale;
          if (soft_cap > 0.f) sc = soft_cap * tanhf(sc / soft_cap);
          p_s[j * TILE + p_own] = p_own < nt ? sc : -INFINITY;
        }
      }
    }
    __syncthreads();
    // (b) online-softmax update of each query head's (m, l); p_s becomes
    // the tile's probabilities exp(s - m_safe) (QUANT: times v_scale,
    // rounded to bf16; l sums them unscaled and unrounded)
    for (int j = warp; j < g; j += WARPS) {
      float* pj = p_s + j * TILE;
      float mx = fmaxf(pj[lane], pj[lane + 32]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[j];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = fmaxf(m_new, -1e30f);
      const float e0 = expf(pj[lane] - m_safe), e1 = expf(pj[lane + 32] - m_safe);
      pj[lane] = QUANT ? round_bf16(e0 * vs_s[lane]) : e0;
      pj[lane + 32] = QUANT ? round_bf16(e1 * vs_s[lane + 32]) : e1;
      float sum = e0 + e1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_safe);
        alpha_s[j] = alpha;
        l_s[j] = l_s[j] * alpha + sum;
        m_s[j] = m_new;
      }
    }
    __syncthreads();
    // (c) acc = acc * alpha + P.V over this thread's two columns
    if (c0 < d) {
#pragma unroll
      for (int j = 0; j < MAX_G; ++j) {
        if (j < g) {
          acc[j][0] *= alpha_s[j];
          acc[j][1] *= alpha_s[j];
        }
      }
      for (int p = 0; p < nt; ++p) {
        const float v0 = to_f32(v_s[p * ld + c0]), v1 = to_f32(v_s[p * ld + c0 + 1]);
#pragma unroll
        for (int j = 0; j < MAX_G; ++j) {
          if (j < g) {
            const float pj = p_s[j * TILE + p];
            acc[j][0] = fmaf(pj, v0, acc[j][0]);
            acc[j][1] = fmaf(pj, v1, acc[j][1]);
          }
        }
      }
    }
    __syncthreads();
  }

  // this span's (out, lse), as _finalize_softmax
#pragma unroll
  for (int j = 0; j < MAX_G; ++j) {
    if (j < g) {
      const float l = l_s[j];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (c0 + c < d) out_part[(row0 + j) * d + c0 + c] = l > 0.f ? acc[j][c] / l : 0.f;
      }
      if (threadIdx.x == 0) lse_part[row0 + j] = l > 0.f ? m_s[j] + logf(l) : -INFINITY;
    }
  }
}

// Merge the spans of each (sequence, query head) row: weights
// exp(lse_s - max(m, -1e30)), spans with lse = -inf weigh 0.
__global__ void __launch_bounds__(THREADS) decode_combine_kernel(
    const float* __restrict__ out_part, const float* __restrict__ lse_part,
    float* __restrict__ out, float* __restrict__ lse, int splits, int rows,
    int d) {
  const int row = blockIdx.x;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, lse_part[(int64_t)s * rows + row]);
  const float m_safe = fmaxf(m, -1e30f);
  float denom = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float ls = lse_part[(int64_t)s * rows + row];
    if (isfinite(ls)) denom += expf(ls - m_safe);
  }
  for (int dd = threadIdx.x; dd < d; dd += THREADS) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float ls = lse_part[(int64_t)s * rows + row];
      if (isfinite(ls)) acc += expf(ls - m_safe) * out_part[((int64_t)s * rows + row) * d + dd];
    }
    out[(int64_t)row * d + dd] = acc / fmaxf(denom, 1e-30f);
  }
  if (threadIdx.x == 0) lse[row] = denom > 0.f ? m_safe + logf(denom) : -INFINITY;
}

// ------------------------------------------- K2 / K3, one launch (bf16) ----
namespace onepass {

using tdt::sm90::bulk_copy;
using tdt::sm90::fence_proxy_async;
using tdt::sm90::mbar_expect_tx;
using tdt::sm90::mbar_init;
using tdt::sm90::mbar_init_fence;
using tdt::sm90::mbar_wait;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;   // positions per online-softmax step (64 / page pages)
constexpr int MAX_BUF = 2; // tiles in flight

// shared-memory carve-up (bytes): nbuf K/V tile pairs, q, the tile's
// probabilities, the softmax statistics, the tiles' page ids, barriers
struct Smem {
  size_t q, p, stats, ids, bars, total;
  __host__ __device__ Smem(int d, int g, int nbuf) {
    q = static_cast<size_t>(nbuf) * 2 * TILE * d * 2;     // [g][d] bf16
    p = (q + static_cast<size_t>(g) * d * 2 + 15) / 16 * 16;  // [g][TILE] f32
    stats = p + static_cast<size_t>(g) * TILE * 4;          // m, l, alpha [3][g] f32
    ids = stats + 3 * g * 4;                                // [nbuf][TILE] int
    bars = (ids + MAX_BUF * TILE * 4 + 7) / 8 * 8;          // nbuf mbarriers, a flag
    total = bars + MAX_BUF * 8 + 8;
  }
};

// Warp 0 issues tile pages [first, last) of (sequence bi, kv head h).
// Paged: the page ids into `ids` (one load a lane, all at once), then lane 0
// fetches each page's K and V slab with one bulk copy each. Contiguous (a
// "page" is the 64-position tile): lane 0 fetches the run of positions
// [first * page, pos1) of the (bi, h) slab [s_len, d] with one bulk copy
// for K and one for V. Both complete on `bar`.
template <bool PAGED>
__device__ __forceinline__ void issue_tile(bf16* kbuf, bf16* vbuf, int* ids, uint64_t* bar,
                                           const bf16* __restrict__ kp,
                                           const bf16* __restrict__ vp,
                                           const int* __restrict__ pages, int first, int last,
                                           int bi, int h, int h_kv, int page, int d, int s_len,
                                           int pos1) {
  const int lane = threadIdx.x % 32;
  if constexpr (PAGED) {
    for (int l = lane; l < last - first; l += 32) ids[l] = pages[first + l];
    __syncwarp();
    if (lane == 0) {
      const uint32_t slab = static_cast<uint32_t>(page) * d * 2;
      mbar_expect_tx(bar, slab * 2 * (last - first));
      for (int pg = 0; pg < last - first; ++pg) {
        const int64_t off = (static_cast<int64_t>(ids[pg]) * h_kv + h) * page * d;
        bulk_copy(kbuf + static_cast<int64_t>(pg) * page * d, kp + off, slab, bar);
        bulk_copy(vbuf + static_cast<int64_t>(pg) * page * d, vp + off, slab, bar);
      }
    }
    __syncwarp();
  } else if (lane == 0) {
    const int t0 = first * page;
    const uint32_t run = static_cast<uint32_t>(min(last * page, pos1) - t0) * d * 2;
    const int64_t off = ((static_cast<int64_t>(bi) * h_kv + h) * s_len + t0) * d;
    mbar_expect_tx(bar, 2 * run);
    bulk_copy(kbuf, kp + off, run, bar);
    bulk_copy(vbuf, vp + off, run, bar);
  }
}

// grid (b * h_kv, splits); block (sequence bi, kv head h, span). G: the
// query heads of a kv head at compile time (0: hq / h_kv at run time, up
// to MAX_G). PAGED: a page pool behind `table` (s_len = page * max_pages);
// else a contiguous cache [b, h_kv, s_len, d] cut into "pages" of one
// 64-position tile (page = TILE, max_pages = ceil(s_len / TILE)).
template <int G, bool PAGED>
__global__ void __launch_bounds__(THREADS) onepass_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kp, const bf16* __restrict__ vp,
    const int* __restrict__ kv_lens, const int* __restrict__ table,
    float* __restrict__ out_part, float* __restrict__ lse_part, int* __restrict__ arrivals,
    float* __restrict__ out, float* __restrict__ lse, int hq, int h_kv, int d, int page,
    int max_pages, int s_len, int span_pages, int nbuf, float scale, float soft_cap) {
  constexpr int GM = G > 0 ? G : MAX_G;  // the register arrays' extent
  extern __shared__ __align__(128) unsigned char smem_op[];
  const int g = G > 0 ? G : hq / h_kv, splits = gridDim.y;
  const int bi = blockIdx.x / h_kv, h = blockIdx.x % h_kv, span = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kv_len = min(kv_lens[bi], s_len);
  const int n_pages = (max(kv_len, 0) + page - 1) / page;
  const int n_spans = (n_pages + span_pages - 1) / span_pages;
  const int64_t row0 = static_cast<int64_t>(bi) * hq + static_cast<int64_t>(h) * g;

  if (n_spans == 0) {  // kv_len == 0: out 0, lse -inf, written by span 0
    if (span == 0) {
      for (int e = tid; e < g * d; e += THREADS) out[row0 * d + e] = 0.f;
      if (tid < g) lse[row0 + tid] = -INFINITY;
    }
    return;
  }
  if (span >= n_spans) return;

  const Smem lay(d, g, nbuf);
  bf16* q_s = reinterpret_cast<bf16*>(smem_op + lay.q);
  float* p_s = reinterpret_cast<float*>(smem_op + lay.p);
  float* m_s = reinterpret_cast<float*>(smem_op + lay.stats);
  float* l_s = m_s + g;
  float* alpha_s = l_s + g;
  int* ids = reinterpret_cast<int*>(smem_op + lay.ids);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_op + lay.bars);
  int* last = reinterpret_cast<int*>(bars + MAX_BUF);
  auto kbuf = [&](int b_) {
    return reinterpret_cast<bf16*>(smem_op) + static_cast<size_t>(b_) * 2 * TILE * d;
  };
  auto vbuf = [&](int b_) { return kbuf(b_) + TILE * d; };

  const int pg0 = span * span_pages, pg1 = min(pg0 + span_pages, n_pages);
  const int pos1 = min(pg1 * page, kv_len);
  const int ppt = TILE / page;
  const int n_tiles = (pg1 - pg0 + ppt - 1) / ppt;
  const int* pages = PAGED ? table + static_cast<int64_t>(bi) * max_pages : nullptr;
  auto issue = [&](int t, int buf) {
    const int first = pg0 + t * ppt;
    issue_tile<PAGED>(kbuf(buf), vbuf(buf), ids + buf * TILE, bars + buf, kp, vp, pages, first,
                      min(first + ppt, pg1), bi, h, h_kv, page, d, s_len, pos1);
  };

  if (tid == 0) {
    for (int i = 0; i < nbuf; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (warp == 0) {
    for (int t = 0; t < min(nbuf, n_tiles); ++t) issue(t, t);
  }
  const bf16* qb = q + row0 * d;
  for (int e = tid; e < g * d; e += THREADS) q_s[e] = qb[e];
  if (tid < g) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[GM][2];
#pragma unroll
  for (int j = 0; j < GM; ++j) acc[j][0] = acc[j][1] = 0.f;
  const int chunks = d / 8;  // 16-byte chunks of a row
  const int sub = tid % 8;   // this thread's chunks: sub, sub + 8, ...
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t % nbuf;
    mbar_wait(bars + buf, (t / nbuf) & 1);
    const bf16* ks = kbuf(buf);
    const bf16* vs = vbuf(buf);
    const int t0 = (pg0 + t * ppt) * page;
    const int nt = min(TILE, pos1 - t0);
    // (a) scores: 16 rows a pass, 8 threads a row, reduced across them
#pragma unroll
    for (int pass = 0; pass < TILE / 16; ++pass) {
      const int row = pass * 16 + tid / 8;
      float s[GM];
#pragma unroll
      for (int j = 0; j < GM; ++j) s[j] = 0.f;
      if (row < nt) {
        for (int c = sub; c < chunks; c += 8) {
          float kf[8];
          load_chunk_f32(ks + row * d + c * 8, kf);
#pragma unroll
          for (int j = 0; j < GM; ++j) {
            if (G > 0 || j < g) {
              float qf[8];
              load_chunk_f32(q_s + j * d + c * 8, qf);
#pragma unroll
              for (int e = 0; e < 8; ++e) s[j] = fmaf(qf[e], kf[e], s[j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < GM; ++j) {
        if (G > 0 || j < g) {
#pragma unroll
          for (int o = 4; o > 0; o >>= 1) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
        }
      }
#pragma unroll
      for (int j = 0; j < GM; ++j) {
        if ((G > 0 || j < g) && j % 8 == sub) {
          float sc = s[j] * scale;
          if (soft_cap > 0.f) sc = soft_cap * tanhf(sc / soft_cap);
          p_s[j * TILE + row] = row < nt ? sc : -INFINITY;
        }
      }
    }
    __syncthreads();
    // (b) online-softmax update of each head's (m, l); p_s becomes exp(s - m_safe)
    for (int j = warp; j < g; j += WARPS) {
      float* pj = p_s + j * TILE;
      float mx = fmaxf(pj[lane], pj[lane + 32]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[j];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = fmaxf(m_new, -1e30f);
      const float e0 = expf(pj[lane] - m_safe), e1 = expf(pj[lane + 32] - m_safe);
      pj[lane] = e0;
      pj[lane + 32] = e1;
      float sum = e0 + e1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_safe);
        alpha_s[j] = alpha;
        l_s[j] = l_s[j] * alpha + sum;
        m_s[j] = m_new;
      }
    }
    __syncthreads();
    // (c) acc = acc * alpha + P.V over this thread's columns tid, tid + 128;
    // four rows a step, the probabilities read as float4
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      const int c = tid + ci * THREADS;
      if (c < d) {
#pragma unroll
        for (int j = 0; j < GM; ++j)
          if (G > 0 || j < g) acc[j][ci] *= alpha_s[j];
        for (int p = 0; p < nt; p += 4) {
          float v[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            v[r] = p + r < nt ? __bfloat162float(vs[(p + r) * d + c]) : 0.f;
#pragma unroll
          for (int j = 0; j < GM; ++j) {
            if (G > 0 || j < g) {
              const float4 pr = *reinterpret_cast<const float4*>(p_s + j * TILE + p);
              float a = acc[j][ci];
              a = fmaf(pr.x, v[0], a);
              a = fmaf(pr.y, v[1], a);
              a = fmaf(pr.z, v[2], a);
              a = fmaf(pr.w, v[3], a);
              acc[j][ci] = a;
            }
          }
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer and with p_s
    if (warp == 0 && t + nbuf < n_tiles) {
      if (lane == 0) fence_proxy_async();
      issue(t + nbuf, buf);
    }
  }

  // this span's (out, lse), as _finalize_softmax; one span: the result
  const bool whole = n_spans == 1;
  const int64_t part = (static_cast<int64_t>(blockIdx.x) * splits + span) * g;
  float* o_dst = whole ? out + row0 * d : out_part + part * d;
  float* l_dst = whole ? lse + row0 : lse_part + part;
#pragma unroll
  for (int j = 0; j < GM; ++j) {
    if (G > 0 || j < g) {
      const float l = l_s[j];
#pragma unroll
      for (int ci = 0; ci < 2; ++ci) {
        const int c = tid + ci * THREADS;
        if (c < d) o_dst[j * d + c] = l > 0.f ? acc[j][ci] / l : 0.f;
      }
      if (tid == 0) l_dst[j] = l > 0.f ? m_s[j] + logf(l) : -INFINITY;
    }
  }
  if (whole) return;

  // the last span of (bi, h) to arrive merges them all, in span order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    *last = atomicAdd(arrivals + blockIdx.x, 1) == n_spans - 1;
    __threadfence();
  }
  __syncthreads();
  if (!*last) return;
  const float* lp = lse_part + static_cast<int64_t>(blockIdx.x) * splits * g;
  const float* op = out_part + static_cast<int64_t>(blockIdx.x) * splits * g * d;
  // each head's max and weight sum, a warp a head, the spans across lanes
  for (int j = warp; j < g; j += WARPS) {
    float m = -INFINITY;
    for (int sp = lane; sp < n_spans; sp += 32) m = fmaxf(m, __ldcg(lp + sp * g + j));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float m_safe = fmaxf(m, -1e30f);
    float denom = 0.f;
    for (int sp = lane; sp < n_spans; sp += 32) {
      const float ls = __ldcg(lp + sp * g + j);
      if (isfinite(ls)) denom += expf(ls - m_safe);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) denom += __shfl_xor_sync(0xffffffffu, denom, o);
    if (lane == 0) {
      m_s[j] = m_safe;
      l_s[j] = denom;
      lse[row0 + j] = denom > 0.f ? m_safe + logf(denom) : -INFINITY;
    }
  }
  __syncthreads();
  for (int e = tid; e < g * d; e += THREADS) {
    const int j = e / d, c = e % d;
    const float m_safe = m_s[j];
    float num = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < n_spans; ++sp) {
      const float ls = __ldcg(lp + sp * g + j);
      const float w = isfinite(ls) ? expf(ls - m_safe) : 0.f;
      num += w * __ldcg(op + (static_cast<int64_t>(sp) * g + j) * d + c);
    }
    out[(row0 + j) * d + c] = num / fmaxf(l_s[j], 1e-30f);
  }
}

}  // namespace onepass

template <typename T, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* kv_lens,
           const void* table, const void* k_scale, const void* v_scale, float* out_part,
           float* lse_part, float* out, float* lse, int b, int hq, int h_kv, int d, int dp,
           int s_len, int page, int max_pages, int splits, int chunk, float scale,
           float soft_cap, cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
  constexpr bool QUANT = sizeof(T) == 1;
  const int g = hq / h_kv;
  if (g > MAX_G || dp % E != 0 || dp > 2 * THREADS || dp < d ||
      (QUANT && (k_scale == nullptr || v_scale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ld = dp + E;
  const size_t n_f32 = (size_t)g * (dp + TILE + 3) + (QUANT ? 2 * TILE : 0);
  const size_t smem = (n_f32 * sizeof(float) + 15) / 16 * 16 + 2 * (size_t)TILE * ld * sizeof(T);
  const int vec = (d % E == 0) && (reinterpret_cast<uintptr_t>(k) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(v) % 16 == 0);
  auto kernel = decode_split_kernel<T, PAGED>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(b * h_kv, splits);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const typename QOf<T>::type*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_lens),
      static_cast<const int*>(table), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), out_part, lse_part, b, hq, h_kv, d, dp, s_len,
      page, max_pages, chunk, scale, soft_cap, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<<<b * hq, THREADS, 0, s>>>(out_part, lse_part, out, lse,
                                                   splits, b * hq, d);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
int dispatch(int dtype, const void* q, const void* k, const void* v, const void* kv_lens,
             const void* table, const void* ks, const void* vs, void* out_part,
             void* lse_part, void* out, void* lse, int b, int hq, int h_kv, int d, int dp,
             int s_len, int page, int max_pages, int splits, int chunk, float scale,
             float soft_cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *op = static_cast<float*>(out_part), *lp = static_cast<float*>(lse_part);
  float *o = static_cast<float*>(out), *l = static_cast<float*>(lse);
  switch (dtype) {
    case kBF16:
      return launch<bf16, PAGED>(q, k, v, kv_lens, table, ks, vs, op, lp, o, l, b, hq, h_kv,
                                 d, dp, s_len, page, max_pages, splits, chunk, scale,
                                 soft_cap, s);
    case kF32:
      return launch<float, PAGED>(q, k, v, kv_lens, table, ks, vs, op, lp, o, l, b, hq, h_kv,
                                  d, dp, s_len, page, max_pages, splits, chunk, scale,
                                  soft_cap, s);
    case kI8:
      return launch<int8_t, PAGED>(q, k, v, kv_lens, table, ks, vs, op, lp, o, l, b, hq,
                                   h_kv, d, dp, s_len, page, max_pages, splits, chunk, scale,
                                   soft_cap, s);
    case kFP8:
      return launch<fp8, PAGED>(q, k, v, kv_lens, table, ks, vs, op, lp, o, l, b, hq, h_kv,
                                d, dp, s_len, page, max_pages, splits, chunk, scale,
                                soft_cap, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// k_scale / v_scale: f32 row scales of a one-byte cache (dtype kI8, kFP8),
// null for a float one.
extern "C" int tdt_flash_decode(const void* q, const void* k, const void* v,
                                const void* kv_lens, const void* k_scale,
                                const void* v_scale, void* out_part, void* lse_part,
                                void* out, void* lse, int dtype, int b, int hq, int h_kv,
                                int d, int dp, int s_len, int splits, int chunk,
                                float scale, float soft_cap, void* stream) {
  return dispatch<false>(dtype, q, k, v, kv_lens, nullptr, k_scale, v_scale, out_part,
                         lse_part, out, lse, b, hq, h_kv, d, dp, s_len, 1, 1, splits, chunk,
                         scale, soft_cap, stream);
}

extern "C" int tdt_paged_flash_decode(const void* q, const void* k, const void* v,
                                      const void* kv_lens, const void* table,
                                      const void* k_scale, const void* v_scale,
                                      void* out_part, void* lse_part, void* out,
                                      void* lse, int dtype, int b, int hq,
                                      int h_kv, int d, int dp, int page,
                                      int max_pages, int splits, int chunk,
                                      float scale, float soft_cap, void* stream) {
  return dispatch<true>(dtype, q, k, v, kv_lens, table, k_scale, v_scale, out_part,
                        lse_part, out, lse, b, hq, h_kv, d, dp, page * max_pages, page,
                        max_pages, splits, chunk, scale, soft_cap, stream);
}

namespace {

// K2 / K3 in one launch over a bf16 cache (onepass_kernel). arrivals: b * h_kv
// int32 counters, zero at the launch; out_part / lse_part: [b * h_kv, splits,
// g] scratch; splits = ceil(max_pages / span_pages); span_pages a multiple
// of 64 / page.
template <bool PAGED>
int launch_onepass(const void* q, const void* k, const void* v, const void* kv_lens,
                   const void* table, void* out_part, void* lse_part, void* arrivals, void* out,
                   void* lse, int b, int hq, int h_kv, int d, int page, int max_pages,
                   int s_len, int span_pages, int splits, float scale, float soft_cap,
                   void* stream) {
  const int g = h_kv > 0 ? hq / h_kv : 0, tile = onepass::TILE;
  if (g < 1 || hq % h_kv || g > MAX_G || d % 8 || d > 2 * onepass::THREADS || page < 1 ||
      tile % page || span_pages < 1 || span_pages % (tile / page) || splits < 1 ||
      static_cast<long long>(splits) * span_pages < max_pages ||
      static_cast<long long>(page) * max_pages < s_len)
    return static_cast<int>(cudaErrorInvalidValue);
  // two tiles in flight where a span has two or more
  const int nbuf = span_pages / (tile / page) >= 2 ? onepass::MAX_BUF : 1;
  const size_t smem = onepass::Smem(d, g, nbuf).total;
  auto go = [&](auto kernel) -> int {
    if (smem > 48 * 1024) {
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<dim3(b * h_kv, splits), onepass::THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const int*>(kv_lens), static_cast<const int*>(table),
        static_cast<float*>(out_part), static_cast<float*>(lse_part),
        static_cast<int*>(arrivals), static_cast<float*>(out), static_cast<float*>(lse), hq,
        h_kv, d, page, max_pages, s_len, span_pages, nbuf, scale, soft_cap);
    return static_cast<int>(cudaGetLastError());
  };
  switch (g) {  // the common group sizes unrolled exactly
    case 1: return go(onepass::onepass_kernel<1, PAGED>);
    case 2: return go(onepass::onepass_kernel<2, PAGED>);
    case 4: return go(onepass::onepass_kernel<4, PAGED>);
    case 8: return go(onepass::onepass_kernel<8, PAGED>);
    default: return go(onepass::onepass_kernel<0, PAGED>);
  }
}

}  // namespace

// K3 over a bf16 page pool [n_pages, h_kv, page, d] behind block_table.
extern "C" int tdt_paged_flash_decode_onepass(
    const void* q, const void* k, const void* v, const void* kv_lens, const void* table,
    void* out_part, void* lse_part, void* arrivals, void* out, void* lse, int b, int hq,
    int h_kv, int d, int page, int max_pages, int span_pages, int splits, float scale,
    float soft_cap, void* stream) {
  return launch_onepass<true>(q, k, v, kv_lens, table, out_part, lse_part, arrivals, out, lse,
                              b, hq, h_kv, d, page, max_pages, page * max_pages, span_pages,
                              splits, scale, soft_cap, stream);
}

// K2 over a contiguous bf16 cache [b, h_kv, s_len, d]: spans of span_tiles
// 64-position tiles, splits = ceil(ceil(s_len / 64) / span_tiles).
extern "C" int tdt_flash_decode_onepass(const void* q, const void* k, const void* v,
                                        const void* kv_lens, void* out_part, void* lse_part,
                                        void* arrivals, void* out, void* lse, int b, int hq,
                                        int h_kv, int d, int s_len, int span_tiles, int splits,
                                        float scale, float soft_cap, void* stream) {
  const int tile = onepass::TILE;
  return launch_onepass<false>(q, k, v, kv_lens, nullptr, out_part, lse_part, arrivals, out,
                               lse, b, hq, h_kv, d, tile, (s_len + tile - 1) / tile, s_len,
                               span_tiles, splits, scale, soft_cap, stream);
}

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
