// K13 · multi-position verify and K14 · its paged twin: S query positions
// of each sequence attend the KV cache in one pass, each position masked by
// its own prefix length, with grouped-query heads. Returns
// (out f32 [b, S, hq, d], lse f32 [b, S, hq]).
//
// Replaces triton_dist_tpu/ops/flash_decode.py:618 _flash_verify_kernel
// (K13, wrapper _flash_verify_fused at :703) and :846
// _paged_flash_verify_kernel (K14, both of its grids). The math is that of
// _online_softmax_step (:195) and _finalize_softmax (:242): scores scaled
// by 1/sqrt(true head dim), the optional soft cap before the length mask,
// m_safe = max(m, -1e30) so a fully masked row never computes inf - inf,
// kv_len = 0 gives out = 0, lse = -inf; the probabilities meet V in the
// cache dtype (bf16 on the MXU there, on the tensor cores here) and are
// summed into l in f32.
//
// What bounds it on the H100: the S*g query rows of a (sequence, kv head)
// share one pass over its cache, so at a prefill chunk (S = 256, g = 4:
// 1024 rows) it does ~1024 FLOPs per cached byte, far above the ~295
// FLOP/byte ridge: it is bound by operations, and in bf16 only the tensor
// cores can approach that bound.
//
// What the design does about it. The TPU kernel holds all S*g rows of a
// (sequence, kv head) in VMEM and walks the KV chunks in sequence; Hopper
// has no sequential grid carry and a block holds far fewer rows, so each
// block owns a tile of rows and walks the whole KV range itself (no split
// over KV, no merge pass), up to the largest prefix length among its rows
// (the per-sequence chunk gate of the TPU kernel, per row tile here).
//
// K13 over a bf16 contiguous cache (d a multiple of 8 up to 256, 16-byte
// aligned operands) runs verify_sm90_kernel: the mma.sync kernel below reached
// 14 % of the operations bound at the served prefill chunk (every thread
// computing cache-row addresses for 16-byte cp.async into two buffers, a
// __syncthreads at every tile serialising the softmax with both products,
// mma.sync short of Hopper's tensor-core rate). The Hopper design
// (FlashAttention-3's arrangement): a producer warp streams K and V tiles by
// TMA from a 2-D tensor map over the cache viewed as [b * h_kv * s_len, d] rows
// into a 4-stage ring (2 at d > 128) of full and empty mbarriers; consumer
// warpgroups of 64 query rows (two a block where a (sequence, kv head) has more
// than 64 rows, one at 64 or fewer: a speculative verify, a one-position chunk)
// run S = Q.K^T and O += P.V as wgmma products, P fed from registers, the
// exponentials on the special-function unit (ex2). Head dims below the padded
// one ride TMA's zero fill past the row's edge; the V rows of the last tile at
// and past the block's extent are zeroed in shared memory (TMA fills past the
// tensor's edge only).
//
// bf16 caches elsewhere (K14's page pool, K40's one-byte tiles raised to
// bf16, unaligned or odd-d operands): 64 rows a block, 16 a warp; Q.K^T and
// P.V are m16n8k16 mma.sync products fed by ldmatrix from shared memory, K
// and V tiles of 64 positions double-buffered with 16-byte cp.async, the
// online-softmax carry in registers (each row's max and sum reduced over
// the 4 threads that hold it). f32 caches (the reference precision): 32
// rows a block, scores, softmax and P.V in f32 FMA from shared memory.
//
// A row's result depends on nothing but its own q row, its own length and
// the cache: the tiles are the same 64-position tiles from position 0 for
// every row; skipping a tile that is masked for every row of a block is
// exact (alpha = 1, p = 0); no choice depends on S or on the row count (the
// wgmma engine's one or two consumer warpgroups compute a row alike).
// So a whole-range call and the calls over its chunks agree bit for bit
// row by row, which the ranged prefill's composition rests on.
//
// K40 · quantized verify: the bf16 kernel over a one-byte cache (int8 or
// fp8 e4m3) with f32 row scales [b, h_kv, 1, s]. Replaces :628
// _flash_verify_quant_kernel (_flash_verify_body with scales; wrapper
// _flash_verify_fused(scales=) at :703). The quantized contract of
// _online_softmax_step (:195-239): q in bf16, the payload raised to bf16
// exactly, each score column times (k_scale[pos] * scale), l over the
// unrounded probabilities, P.V on (p * v_scale[pos]) rounded to bf16. The
// one-byte K and V tiles ride 16-byte cp.async copies into a double-
// buffered staging area (half the bytes of a bf16 tile), then rise to a bf16
// tile in shared memory that ldmatrix reads as before; the tile's scales
// are staged beside them. k_scale folds into each score fragment's column
// and v_scale into P's column before the bf16 pack. Nothing here depends on
// S or on the row count either, so chunk calls stay bit-equal to the
// whole-range call. What bounds it at a prefill chunk: still operations
// (the cache bytes halve, the products do not).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "sm90.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };
typedef __nv_bfloat16 bf16;
typedef __nv_fp8_e4m3 fp8;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;      // cache positions per online-softmax step
constexpr int MMA_ROWS = 64;  // query rows a block (bf16): 16 a warp
constexpr int FMA_ROWS = 32;  // query rows a block (f32)

// Where rows and cache positions live. Row r of (sequence bi, kv head h) is
// position s = r / g, group member j = r % g: q[bi, s, h*g + j, :].
struct Geo {
  int b, S, hq, h_kv, g, d, s_len, page, max_pages;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }
template <> __device__ __forceinline__ int8_t zero<int8_t>() { return 0; }
template <> __device__ __forceinline__ fp8 zero<fp8>() { return fp8(0.f); }

__device__ __forceinline__ float byte_to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float byte_to_f32(fp8 x) { return (float)x; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Row index of cache position (sequence bi, kv head h, position pos):
// contiguous [b, h_kv, s_len, .], or the page pool [n_pages, h_kv, page, .]
// through block_table [b, max_pages]. Times d it is the payload row's
// element offset; alone it is the row scale's ([.., h_kv, 1, s_len or page]).
template <bool PAGED>
__device__ __forceinline__ int64_t pos_index(const Geo& G, const int* __restrict__ table,
                                             int bi, int h, int pos) {
  if (PAGED) {
    const int pid = table[(int64_t)bi * G.max_pages + pos / G.page];
    return ((int64_t)pid * G.h_kv + h) * G.page + pos % G.page;
  }
  return ((int64_t)bi * G.h_kv + h) * G.s_len + pos;
}
template <bool PAGED>
__device__ __forceinline__ int64_t cache_row(const Geo& G, const int* __restrict__ table,
                                             int bi, int h, int pos) {
  return pos_index<PAGED>(G, table, bi, h, pos) * G.d;
}

// A one-byte cache's k and v scales of positions [t0, t0 + TILE), 0 at and
// past `valid` (a masked probability of 0 then meets a finite 0).
template <bool PAGED>
__device__ __forceinline__ void stage_scales(float* ks_dst, float* vs_dst,
                                             const float* __restrict__ k_scale,
                                             const float* __restrict__ v_scale, const Geo& G,
                                             const int* __restrict__ table, int bi, int h,
                                             int t0, int valid) {
  for (int p = threadIdx.x; p < TILE; p += THREADS) {
    const bool in = t0 + p < valid;
    const int64_t o = in ? pos_index<PAGED>(G, table, bi, h, t0 + p) : 0;
    ks_dst[p] = in ? k_scale[o] : 0.f;
    vs_dst[p] = in ? v_scale[o] : 0.f;
  }
}

// A staged one-byte tile [TILE][DP] raised to a bf16 tile [TILE][ld]
// (exact: every int8 and e4m3 value is a bf16 value).
template <typename T, int DP>
__device__ __forceinline__ void raise_tile(bf16* dst, int ld, const T* src) {
  constexpr int CPR = DP / 16;
  for (int e = threadIdx.x; e < TILE * CPR; e += THREADS) {
    const int p = e / CPR, c = (e % CPR) * 16;
    const uint4 u = *reinterpret_cast<const uint4*>(src + p * DP + c);
    const T* x = reinterpret_cast<const T*>(&u);
    uint4 w[2];
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(w);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o2[i] = __floats2bfloat162_rn(byte_to_f32(x[2 * i]), byte_to_f32(x[2 * i + 1]));
    uint4* out = reinterpret_cast<uint4*>(dst + p * ld + c);
    out[0] = w[0];
    out[1] = w[1];
  }
}

__device__ __forceinline__ int64_t q_row(const Geo& G, int bi, int h, int r) {
  const int s = r / G.g, j = r % G.g;
  return ((int64_t)bi * G.S + s) * G.hq + (int64_t)h * G.g + j;
}

// This row's prefix length, clamped into the cache; 0 for a row past S*g.
__device__ __forceinline__ int row_len(const Geo& G, const int* __restrict__ lens, int bi,
                                       int r) {
  if (r >= G.S * G.g) return 0;
  return min(max(lens[(int64_t)bi * G.S + r / G.g], 0), G.s_len);
}

// Stage cache positions [t0, t0 + TILE) of (bi, h) into `dst` (rows of
// `ld` elements, dp columns): positions below `valid` are loaded (16-byte
// cp.async when `vec`), the rest and the columns past d are zero, so a
// masked probability of 0 never meets stale shared memory.
template <typename T, bool PAGED>
__device__ __forceinline__ void stage_tile(T* dst, int ld, int dp, const T* __restrict__ src,
                                           const Geo& G, const int* __restrict__ table,
                                           int bi, int h, int t0, int valid, bool vec) {
  constexpr int E = 16 / sizeof(T);
  const int cpr = dp / E;
  for (int e = threadIdx.x; e < TILE * cpr; e += THREADS) {
    const int p = e / cpr, c = (e % cpr) * E;
    T* out = dst + p * ld + c;
    if (t0 + p < valid && c < G.d) {
      const T* row = src + cache_row<PAGED>(G, table, bi, h, t0 + p);
      if (vec) {
        cp_async16(out, row + c);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) out[i] = c + i < G.d ? row[c + i] : zero<T>();
      }
    } else {
      *reinterpret_cast<uint4*>(out) = make_uint4(0, 0, 0, 0);
    }
  }
}

// The block's KV extent: the largest prefix length among its rows.
__device__ __forceinline__ int block_extent(const Geo& G, const int* __restrict__ lens, int bi,
                                            int row0, int rows, int* red) {
  if (threadIdx.x == 0) *red = 0;
  __syncthreads();
  if (threadIdx.x < rows) atomicMax(red, row_len(G, lens, bi, row0 + threadIdx.x));
  __syncthreads();
  return *red;
}

// ------------------------------------------------------------ bf16 (mma) --

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
// d += a . b for one m16n8k16 tile, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Grid (row tiles of 64, h_kv, b), 128 threads. Warp w owns rows
// [16w, 16w + 16) of the tile; in mma fragment terms a thread holds rows
// gid and gid + 8 (gid = lane / 4) and, of each 8-wide n tile, the columns
// 2 * (lane % 4) and +1. T is the cache's type: bf16 (K13/K14), or int8 /
// fp8 (K40: staged in one byte, raised to a single bf16 tile, row scales
// folded in).
template <int DP, bool PAGED, typename T>
__global__ void __launch_bounds__(THREADS) verify_mma_kernel(
    const bf16* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lens, const int* __restrict__ table,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    float* __restrict__ out, float* __restrict__ lse, Geo G, float scale, float soft_cap,
    int vec) {
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr int LD = DP + 8;  // +16 bytes a row staggers ldmatrix banks
  constexpr int NT = DP / 8;  // 8-wide head-dim tiles of the output
  constexpr int KV_BUFS = QUANT ? 1 : 2;  // bf16 tiles (QUANT: one, raised from staging)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);        // [64][LD]
  bf16* k_s = q_s + MMA_ROWS * LD;                  // [KV_BUFS][TILE][LD]
  bf16* v_s = k_s + KV_BUFS * TILE * LD;            // [KV_BUFS][TILE][LD]
  // QUANT: the one-byte staging [2][TILE][DP] each, then the scales [2][TILE] each
  T* k8_s = reinterpret_cast<T*>(v_s + KV_BUFS * TILE * LD);
  T* v8_s = k8_s + 2 * TILE * DP;
  float* ks_s = reinterpret_cast<float*>(v8_s + 2 * TILE * DP);
  float* vs_s = ks_s + 2 * TILE;
  __shared__ int extent_s;

  const int bi = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * MMA_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int extent = block_extent(G, lens, bi, row0, MMA_ROWS, &extent_s);
  const int n_tiles = cdiv(extent, TILE);
  // this thread's two rows and their prefix lengths
  const int r_lo = row0 + warp * 16 + gid, r_hi = r_lo + 8;
  const int len_lo = row_len(G, lens, bi, r_lo), len_hi = row_len(G, lens, bi, r_hi);

  // stage cache tile `t` into buffer `nb` (QUANT: the one-byte staging and
  // its scales)
  auto stage = [&](int t, int nb) {
    if constexpr (QUANT) {
      stage_tile<T, PAGED>(k8_s + nb * TILE * DP, DP, DP, k, G, table, bi, h, t * TILE,
                           extent, vec);
      stage_tile<T, PAGED>(v8_s + nb * TILE * DP, DP, DP, v, G, table, bi, h, t * TILE,
                           extent, vec);
      stage_scales<PAGED>(ks_s + nb * TILE, vs_s + nb * TILE, k_scale, v_scale, G, table, bi,
                          h, t * TILE, extent);
    } else {
      stage_tile<bf16, PAGED>(k_s + nb * TILE * LD, LD, DP, k, G, table, bi, h, t * TILE,
                              extent, vec);
      stage_tile<bf16, PAGED>(v_s + nb * TILE * LD, LD, DP, v, G, table, bi, h, t * TILE,
                              extent, vec);
    }
  };

  // q rows of the tile, zero past S*g and past d
  for (int e = threadIdx.x; e < MMA_ROWS * (DP / 8); e += THREADS) {
    const int rr = e / (DP / 8), c = (e % (DP / 8)) * 8;
    bf16* dst = q_s + rr * LD + c;
    const int r = row0 + rr;
    if (r < G.S * G.g && c < G.d) {
      const bf16* src = q + q_row(G, bi, h, r) * G.d + c;
      if (vec) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) dst[i] = c + i < G.d ? src[i] : __float2bfloat16(0.f);
      }
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  if (n_tiles > 0) stage(0, 0);
  cp_async_commit();

  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  const bf16* q_w = q_s + warp * 16 * LD;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      stage(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = k_s + (QUANT ? 0 : buf) * TILE * LD;
    const bf16* vt = v_s + (QUANT ? 0 : buf) * TILE * LD;
    const float* ks_t = ks_s + buf * TILE;
    const float* vs_t = vs_s + buf * TILE;
    if constexpr (QUANT) {
      raise_tile<T, DP>(k_s, LD, k8_s + buf * TILE * DP);
      raise_tile<T, DP>(v_s, LD, v8_s + buf * TILE * DP);
      __syncthreads();
    }
    const int t0 = it * TILE;

    // (a) S = Q . K^T over the tile: 8 n tiles of 8 positions
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, q_w + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bfr[4];
        const int mi = lane / 8;
        ldmatrix_x4(bfr, kt + (np * 16 + (mi / 2) * 8 + lane % 8) * LD + kk * 16 + (mi % 2) * 8);
        mma_bf16(s[2 * np], a, bfr);
        mma_bf16(s[2 * np + 1], a, bfr + 2);
      }
    }
    // (b) scale (QUANT: dot * (k_scale * scale), the reference's order),
    // soft cap, length mask; the online-softmax update of the thread's two
    // rows
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * tig + (e & 1);
        const int pos = t0 + col;
        float sc = s[nt][e] * (QUANT ? ks_t[col] * scale : scale);
        if (soft_cap > 0.f) sc = soft_cap * tanhf(sc / soft_cap);
        sc = pos < (e < 2 ? len_lo : len_hi) ? sc : -INFINITY;
        s[nt][e] = sc;
        if (e < 2) mx_lo = fmaxf(mx_lo, sc); else mx_hi = fmaxf(mx_hi, sc);
      }
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o_));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o_));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float ms_lo = fmaxf(mn_lo, -1e30f), ms_hi = fmaxf(mn_hi, -1e30f);
    const float al_lo = expf(m_lo - ms_lo), al_hi = expf(m_hi - ms_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - ms_lo);
      s[nt][1] = expf(s[nt][1] - ms_lo);
      s[nt][2] = expf(s[nt][2] - ms_hi);
      s[nt][3] = expf(s[nt][3] - ms_hi);
      sum_lo += s[nt][0] + s[nt][1];
      sum_hi += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, o_);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, o_);
    }
    l_lo = l_lo * al_lo + sum_lo;
    l_hi = l_hi * al_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][0] *= al_lo;
      o[nt][1] *= al_lo;
      o[nt][2] *= al_hi;
      o[nt][3] *= al_hi;
    }
    // QUANT: P's columns times v_scale (l above summed them unscaled)
    if constexpr (QUANT) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float v0 = vs_t[nt * 8 + 2 * tig], v1 = vs_t[nt * 8 + 2 * tig + 1];
        s[nt][0] *= v0;
        s[nt][1] *= v1;
        s[nt][2] *= v0;
        s[nt][3] *= v1;
      }
    }
    // (c) O += P . V, P rounded to bf16 (the accumulator layout of two
    // neighbouring n tiles is the A fragment of one 16-deep k step)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned a[4];
      a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bfr[4];
        const int mi = lane / 8;
        ldmatrix_x4_trans(bfr, vt + (j * 16 + (mi % 2) * 8 + lane % 8) * LD + np * 16 +
                                   (mi / 2) * 8);
        mma_bf16(o[2 * np], a, bfr);
        mma_bf16(o[2 * np + 1], a, bfr + 2);
      }
    }
    __syncthreads();
  }

  cp_async_wait<0>();  // nothing in flight at exit (n_tiles == 0)
  // (out, lse) as _finalize_softmax
  const int rows = G.S * G.g;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r_hi : r_lo;
    if (r >= rows) continue;
    const float l = half ? l_hi : l_lo, m = half ? m_hi : m_lo;
    const int64_t qr = q_row(G, bi, h, r);
    float* orow = out + qr * G.d;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * tig + e;
        if (c < G.d) orow[c] = l > 0.f ? o[nt][2 * half + e] / l : 0.f;
      }
    }
    if (tig == 0) lse[qr] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

// ------------------------------------------------ bf16 (wgmma + TMA, K13) --
namespace wg {

using tdt::sm90::fence_acc;
using tdt::sm90::fence_proxy_async;
using tdt::sm90::KMAJOR_LBO;
using tdt::sm90::KMAJOR_SBO;
using tdt::sm90::make_map;
using tdt::sm90::mbar_arrive;
using tdt::sm90::mbar_expect_tx;
using tdt::sm90::mbar_init;
using tdt::sm90::mbar_init_fence;
using tdt::sm90::mbar_wait;
using tdt::sm90::MNMAJOR_LBO;
using tdt::sm90::MNMAJOR_SBO;
using tdt::sm90::named_barrier;
using tdt::sm90::reg_alloc;
using tdt::sm90::reg_dealloc;
using tdt::sm90::smem_desc;
using tdt::sm90::smem_u32;
using tdt::sm90::tma_load_2d;
using tdt::sm90::wgmma_commit;
using tdt::sm90::wgmma_fence;
using tdt::sm90::wgmma_wait;

constexpr int BOX = 64;  // positions a tile, columns a box: one 128-byte swizzle row of bf16
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (about 2 ulps; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// DP: the head dim padded to 64, 128 or 256 (zero past d); WGS consumer
// warpgroups of 64 query rows each
template <int DP, int WGS>
struct Layout {
  static constexpr int BM = 64 * WGS;
  static constexpr int THREADS = 128 * (WGS + 1);
  static constexpr int STAGES = DP <= 128 ? 4 : 2;
  static constexpr int Q_ELEMS = BM * DP;
  static constexpr int TILE_ELEMS = BOX * DP;  // one K or V tile
  static constexpr uint32_t STAGE_BYTES = 2 * TILE_ELEMS * 2;
  // q, the stages, their full and empty barriers; +1024 to align the base
  static constexpr size_t SMEM =
      static_cast<size_t>(Q_ELEMS + STAGES * 2 * TILE_ELEMS) * 2 + 2 * STAGES * 8 + 1024;
  static_assert(SMEM <= 232448, "fits a block's shared memory");
};

// Grid (row tiles of 64 * WGS, h_kv, b). Warpgroup 0 is the producer: one
// thread streams the (sequence, kv head)'s 64-position K and V tiles by TMA
// into a STAGES-deep ring (each tile NB boxes of [64 positions][64 columns],
// 128-byte swizzled, zero past d) on "full" mbarriers. Warpgroups 1..WGS are
// consumers of 64 rows each: S = Q . K^T by wgmma m64n64k16 (Q and the K
// tile both K-major in shared memory), the scale, soft cap, per-row length
// mask and online softmax on the score fragments in registers (a row's max
// and sum reduced over the 4 threads that hold it), then O += P . V by
// wgmma m64nDPk16 with P rounded to bf16 in registers (the accumulator
// layout of two neighbouring 8-column blocks is the A fragment of one
// 16-deep k step) and the V tile MN-major; then the stage goes back on its
// "empty" mbarrier. (Issuing the next tile's S before this tile's softmax,
// FlashAttention-3's intra-warpgroup overlap, timed within 1 % of this on
// an H100 at the served prefill chunk, so it is not done.)
template <int DP, int WGS>
__global__ void __launch_bounds__(Layout<DP, WGS>::THREADS, 1) verify_sm90_kernel(
    const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
    const bf16* __restrict__ q, const int* __restrict__ lens, float* __restrict__ out,
    float* __restrict__ lse, Geo G, float scale, float soft_cap) {
  using L = Layout<DP, WGS>;
  constexpr int NB = DP / BOX;  // boxes of a row
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles want 1024-byte aligned boxes
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* q_s = reinterpret_cast<bf16*>(base);       // [WGS][NB][64 rows][64]
  bf16* kv_s = q_s + L::Q_ELEMS;                    // [STAGES][K, V][NB][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_s + L::STAGES * 2 * L::TILE_ELEMS);
  uint64_t* empty = full + L::STAGES;
  __shared__ int extent_s;

  const int bi = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * L::BM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * WGS);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  const int extent = block_extent(G, lens, bi, row0, L::BM, &extent_s);
  const int n_tiles = cdiv(extent, BOX);
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // ---------------------------------------------------------- producer ----
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const int row_base = (bi * G.h_kv + h) * G.s_len;  // of the [b*h_kv*s_len, d] view
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % L::STAGES;
        mbar_wait(empty + st, ((t / L::STAGES) & 1) ^ 1);
        mbar_expect_tx(full + st, L::STAGE_BYTES);
        bf16* kt = kv_s + st * 2 * L::TILE_ELEMS;
#pragma unroll
        for (int bx = 0; bx < NB; ++bx) {
          tma_load_2d(kt + bx * BOX * BOX, &map_k, bx * BOX, row_base + t * BOX, full + st);
          tma_load_2d(kt + L::TILE_ELEMS + bx * BOX * BOX, &map_v, bx * BOX, row_base + t * BOX,
                      full + st);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers ----
  reg_alloc<CONSUMER_REGS>();
  const int cw = wg - 1, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int rows = G.S * G.g, wrow0 = row0 + cw * 64;
  bf16* qw = q_s + cw * 64 * DP;
  // this warpgroup's q rows, swizzled as TMA would (16-byte chunk c of row r
  // at chunk c ^ (r % 8)), zero past S*g and past d
  for (int e = tid; e < 64 * (DP / 8); e += 128) {
    const int r = e / (DP / 8), c = (e % (DP / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (wrow0 + r < rows && c < G.d)
      val = *reinterpret_cast<const uint4*>(q + q_row(G, bi, h, wrow0 + r) * G.d + c);
    *reinterpret_cast<uint4*>(qw + (c / BOX) * BOX * BOX + r * BOX +
                              (((c % BOX) / 8) ^ (r % 8)) * 8) = val;
  }
  fence_proxy_async();
  named_barrier(2 + cw, 128);

  // this thread's two rows and their prefix lengths
  const int r_lo = wrow0 + warp * 16 + gid, r_hi = r_lo + 8;
  const int len_lo = row_len(G, lens, bi, r_lo), len_hi = row_len(G, lens, bi, r_hi);
  float o[DP / 2], s[32];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % L::STAGES;
    mbar_wait(full + st, (t / L::STAGES) & 1);
    const bf16* kt = kv_s + st * 2 * L::TILE_ELEMS;
    bf16* vt = kv_s + st * 2 * L::TILE_ELEMS + L::TILE_ELEMS;
    const int t0 = t * BOX;

    // (a) S = Q . K^T over the tile's 64 positions
    fence_acc<32>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk / 4) * BOX * BOX + (kk % 4) * 16;
      tdt::sm90::wgmma_m64n64k16<0>(s, smem_desc(qw + off, KMAJOR_LBO, KMAJOR_SBO),
                                    smem_desc(kt + off, KMAJOR_LBO, KMAJOR_SBO), kk > 0);
    }
    wgmma_commit();
    if (t0 + BOX > extent) {
      // the last tile: TMA filled its rows at and past the block's extent
      // with whatever the cache holds there; a masked p = 0 must meet a
      // finite 0, so the consumers zero those V rows (whole 128-byte rows,
      // so the swizzle does not matter) before either reads them
      const int z0 = extent - t0;
      for (int e = cw * 128 + tid; e < (BOX - z0) * NB * 8; e += 128 * WGS) {
        const int r = z0 + e / (NB * 8), rest = e % (NB * 8);
        *reinterpret_cast<uint4*>(vt + (rest / 8) * BOX * BOX + r * BOX + (rest % 8) * 8) =
            make_uint4(0, 0, 0, 0);
      }
      fence_proxy_async();
      named_barrier(1, 128 * WGS);
    }
    wgmma_wait<0>();
    fence_acc<32>(s);

    // (b) scale, soft cap, length mask; the online-softmax update of the
    // thread's two rows (s[nb * 4 + e]: row lo for e < 2, hi else; column
    // nb * 8 + 2 * tig + e % 2, kept where it is below the row's length).
    // The exponentials are 2^((s - m) log2 e) on the special-function unit:
    // the softmax's instructions weigh as much as the products in this loop
    const int lim_lo = len_lo - t0 - 2 * tig, lim_hi = len_hi - t0 - 2 * tig;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float sc = s[i] * scale;
      if (soft_cap > 0.f) sc = soft_cap * tanhf(sc / soft_cap);
      sc = (i / 4) * 8 + (i & 1) < ((i & 2) ? lim_hi : lim_lo) ? sc : -INFINITY;
      s[i] = sc;
      if (i & 2) mx_hi = fmaxf(mx_hi, sc); else mx_lo = fmaxf(mx_lo, sc);
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o_));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o_));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float ms_lo = fmaxf(mn_lo, -1e30f), ms_hi = fmaxf(mn_hi, -1e30f);
    // alpha exactly 1 where the max did not move (a tile masked for the row
    // leaves its carry bit for bit as it was: the chunk calls' composition)
    const float al_lo = mn_lo == m_lo ? 1.f : ex2((m_lo - ms_lo) * LOG2E);
    const float al_hi = mn_hi == m_hi ? 1.f : ex2((m_hi - ms_hi) * LOG2E);
    const float mb_lo = ms_lo * LOG2E, mb_hi = ms_hi * LOG2E;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = ex2(fmaf(s[i], LOG2E, -((i & 2) ? mb_hi : mb_lo)));
      if (i & 2) sum_hi += s[i]; else sum_lo += s[i];
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, o_);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, o_);
    }
    l_lo = l_lo * al_lo + sum_lo;
    l_hi = l_hi * al_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= (i & 2) ? al_hi : al_lo;

    // (c) O += P . V, P rounded to bf16 in registers
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pa[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
      pa[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
      pa[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
      pa[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
    }
    fence_acc<DP / 2>(o);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      tdt::sm90::wgmma_rs_step<DP>(o, pa[j], smem_desc(vt + j * 16 * BOX, MNMAJOR_LBO,
                                                       MNMAJOR_SBO), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<DP / 2>(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }

  // (out, lse) as _finalize_softmax
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r_hi : r_lo;
    if (r >= rows) continue;
    const float l = half ? l_hi : l_lo, m = half ? m_hi : m_lo;
    const int64_t qr = q_row(G, bi, h, r);
    float* orow = out + qr * G.d;
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      const int c = nb * 8 + 2 * tig;
      if (c < G.d)
        *reinterpret_cast<float2*>(orow + c) =
            make_float2(l > 0.f ? o[nb * 4 + 2 * half] / l : 0.f,
                        l > 0.f ? o[nb * 4 + 2 * half + 1] / l : 0.f);
    }
    if (tig == 0) lse[qr] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

}  // namespace wg

// ------------------------------------------------------------- f32 (FMA) --

// Grid (row tiles of 32, h_kv, b), 128 threads. Per 64-position tile:
// thread t scores position t % 64 against rows t / 64, +2, ...; one warp
// per row updates its (m, l); then thread t owns output column t (and
// t + 128) of every row.
template <bool PAGED>
__global__ void __launch_bounds__(THREADS) verify_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ lens, const int* __restrict__ table, float* __restrict__ out,
    float* __restrict__ lse, Geo G, int dp, float scale, float soft_cap, int vec) {
  constexpr int R = FMA_ROWS;
  constexpr int HALF = R / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = dp + 4;
  float* q_s = reinterpret_cast<float*>(smem);  // [R][dp]
  float* k_s = q_s + R * dp;                     // [TILE][ld]
  float* v_s = k_s + TILE * ld;                  // [TILE][ld]
  float* p_s = v_s + TILE * ld;                  // [R][TILE]
  float* m_s = p_s + R * TILE;                   // [R]
  float* l_s = m_s + R;
  float* alpha_s = l_s + R;
  int* len_s = reinterpret_cast<int*>(alpha_s + R);
  __shared__ int extent_s;

  const int bi = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int extent = block_extent(G, lens, bi, row0, R, &extent_s);
  const int rows = G.S * G.g;
  for (int e = threadIdx.x; e < R * dp; e += THREADS) {
    const int rr = e / dp, c = e % dp, r = row0 + rr;
    q_s[e] = (r < rows && c < G.d) ? q[q_row(G, bi, h, r) * G.d + c] : 0.f;
  }
  if (threadIdx.x < R) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
    len_s[threadIdx.x] = row_len(G, lens, bi, row0 + threadIdx.x);
  }
  float acc[2][R];
#pragma unroll
  for (int cc = 0; cc < 2; ++cc)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[cc][r] = 0.f;
  const int p_own = threadIdx.x % TILE, rh = threadIdx.x / TILE;

  for (int t0 = 0; t0 < extent; t0 += TILE) {
    stage_tile<float, PAGED>(k_s, ld, dp, k, G, table, bi, h, t0, extent, vec);
    stage_tile<float, PAGED>(v_s, ld, dp, v, G, table, bi, h, t0, extent, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // (a) scores of position p_own against rows rh, rh + 2, ...
    {
      float s[HALF];
#pragma unroll
      for (int i = 0; i < HALF; ++i) s[i] = 0.f;
      const float* kr = k_s + p_own * ld;
      for (int c = 0; c < dp; c += 4) {
        const float4 kf = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
        for (int i = 0; i < HALF; ++i) {
          const float4 qf = *reinterpret_cast<const float4*>(q_s + (rh + 2 * i) * dp + c);
          s[i] = fmaf(qf.x, kf.x, s[i]);
          s[i] = fmaf(qf.y, kf.y, s[i]);
          s[i] = fmaf(qf.z, kf.z, s[i]);
          s[i] = fmaf(qf.w, kf.w, s[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const int r = rh + 2 * i;
        float sc = s[i] * scale;
        if (soft_cap > 0.f) sc = soft_cap * tanhf(sc / soft_cap);
        p_s[r * TILE + p_own] = t0 + p_own < len_s[r] ? sc : -INFINITY;
      }
    }
    __syncthreads();
    // (b) each row's online-softmax update; p_s becomes exp(s - m_safe)
    for (int r = warp; r < R; r += WARPS) {
      float* pr = p_s + r * TILE;
      float mx = fmaxf(pr[lane], pr[lane + 32]);
#pragma unroll
      for (int o_ = 16; o_ > 0; o_ >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = fmaxf(m_new, -1e30f);
      const float e0 = expf(pr[lane] - m_safe), e1 = expf(pr[lane + 32] - m_safe);
      pr[lane] = e0;
      pr[lane + 32] = e1;
      float sum = e0 + e1;
#pragma unroll
      for (int o_ = 16; o_ > 0; o_ >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o_);
      if (lane == 0) {
        const float alpha = expf(m_old - m_safe);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // (c) acc = acc * alpha + P . V over this thread's columns
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = threadIdx.x + cc * THREADS;
      if (c < dp) {
#pragma unroll
        for (int r = 0; r < R; ++r) acc[cc][r] *= alpha_s[r];
        for (int p = 0; p < TILE; ++p) {
          const float vv = v_s[p * ld + c];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[cc][r] = fmaf(p_s[r * TILE + p], vv, acc[cc][r]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {
    const int c = threadIdx.x + cc * THREADS;
    if (c >= G.d) continue;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row0 + r < rows) {
        const float l = l_s[r];
        out[q_row(G, bi, h, row0 + r) * G.d + c] = l > 0.f ? acc[cc][r] / l : 0.f;
      }
    }
  }
  if (threadIdx.x < R && row0 + threadIdx.x < rows) {
    const int r = threadIdx.x;
    const float l = l_s[r];
    lse[q_row(G, bi, h, row0 + r)] = l > 0.f ? m_s[r] + logf(l) : -INFINITY;
  }
}

// ------------------------------------------------------------- launchers --

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

int pow2_at_least(int d, int lo) {
  int p = lo;
  while (p < d) p <<= 1;
  return p;
}

template <int DP, bool PAGED, typename T>
int launch_mma(const void* q, const void* k, const void* v, const void* lens,
               const void* table, const void* k_scale, const void* v_scale, float* out,
               float* lse, const Geo& G, float scale, float soft_cap, cudaStream_t st) {
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr int LD = DP + 8;
  // q, the bf16 K/V tiles (two buffers, or one raised from the one-byte
  // staging), and for a one-byte cache the staging and the scales
  const size_t smem = (size_t)(MMA_ROWS + (QUANT ? 2 : 4) * TILE) * LD * sizeof(bf16) +
                      (QUANT ? 4 * (size_t)TILE * DP + 4 * TILE * sizeof(float) : 0);
  if (QUANT && (k_scale == nullptr || v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = verify_mma_kernel<DP, PAGED, T>;
  if (int rc = set_smem(kernel, smem)) return rc;
  // 16-byte copies: 8 bf16 of q, 8 bf16 or 16 one-byte values of the cache
  const int vec = (G.d % (16 / (int)sizeof(T)) == 0) && (G.d % 8 == 0) &&
                  (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(k) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(v) % 16 == 0);
  const dim3 grid(cdiv(G.S * G.g, MMA_ROWS), G.h_kv, G.b);
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lens), static_cast<const int*>(table),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), out, lse, G,
      scale, soft_cap, vec);
  return static_cast<int>(cudaGetLastError());
}

// the mma head dim: the power of two >= d (_kernel_head_dim), at least 64
template <bool PAGED, typename T>
int launch_mma_dp(const void* q, const void* k, const void* v, const void* lens,
                  const void* table, const void* ks, const void* vs, float* o, float* l,
                  const Geo& G, float scale, float soft_cap, cudaStream_t st) {
  switch (pow2_at_least(G.d, 64)) {
    case 64:
      return launch_mma<64, PAGED, T>(q, k, v, lens, table, ks, vs, o, l, G, scale, soft_cap,
                                      st);
    case 128:
      return launch_mma<128, PAGED, T>(q, k, v, lens, table, ks, vs, o, l, G, scale,
                                       soft_cap, st);
    default:
      return launch_mma<256, PAGED, T>(q, k, v, lens, table, ks, vs, o, l, G, scale,
                                       soft_cap, st);
  }
}

template <int DP, int WGS>
int launch_sm90(const void* q, const void* k, const void* v, const void* lens, float* out,
                float* lse, const Geo& G, float scale, float soft_cap, cudaStream_t st) {
  using L = wg::Layout<DP, WGS>;
  // the cache as [b * h_kv * s_len, d] rows, boxes of [64 rows][64 columns]
  const long long dims[2] = {G.d, std::max(1LL, static_cast<long long>(G.b) * G.h_kv * G.s_len)};
  const long long box[2] = {wg::BOX, wg::BOX};
  CUtensorMap mk, mv;
  cudaError_t err = wg::make_map(&mk, k, dims, 2LL * G.d, box);
  if (err == cudaSuccess) err = wg::make_map(&mv, v, dims, 2LL * G.d, box);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = wg::verify_sm90_kernel<DP, WGS>;
  if (int rc = set_smem(kernel, L::SMEM)) return rc;
  const dim3 grid(cdiv(G.S * G.g, L::BM), G.h_kv, G.b);
  kernel<<<grid, L::THREADS, L::SMEM, st>>>(mk, mv, static_cast<const bf16*>(q),
                                             static_cast<const int*>(lens), out, lse, G, scale,
                                             soft_cap);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_sm90_rows(const void* q, const void* k, const void* v, const void* lens, float* o,
                     float* l, const Geo& G, float scale, float soft_cap, cudaStream_t st) {
  // two consumer warpgroups where a (sequence, kv head) has more than 64 rows
  return G.S * G.g > 64 ? launch_sm90<DP, 2>(q, k, v, lens, o, l, G, scale, soft_cap, st)
                        : launch_sm90<DP, 1>(q, k, v, lens, o, l, G, scale, soft_cap, st);
}

template <bool PAGED>
int launch_fma(const void* q, const void* k, const void* v, const void* lens,
               const void* table, float* out, float* lse, const Geo& G, float scale,
               float soft_cap, cudaStream_t st) {
  const int dp = pow2_at_least(G.d, 4);  // at least one 16-byte chunk a row
  const size_t smem = ((size_t)FMA_ROWS * dp + 2 * (size_t)TILE * (dp + 4) +
                       (size_t)FMA_ROWS * TILE + 4 * FMA_ROWS) * sizeof(float);
  auto kernel = verify_fma_kernel<PAGED>;
  if (int rc = set_smem(kernel, smem)) return rc;
  const int vec = (G.d % 4 == 0) && (reinterpret_cast<uintptr_t>(k) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(v) % 16 == 0);
  const dim3 grid(cdiv(G.S * G.g, FMA_ROWS), G.h_kv, G.b);
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(lens),
      static_cast<const int*>(table), out, lse, G, dp, scale, soft_cap, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* lens, const void* table,
           const void* ks, const void* vs, void* out, void* lse, int dtype, Geo G,
           float scale, float soft_cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *o = static_cast<float*>(out), *l = static_cast<float*>(lse);
  if (G.h_kv <= 0 || G.hq % G.h_kv != 0 || G.d < 1 || G.d > 256 || G.b < 1 || G.S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  G.g = G.hq / G.h_kv;
  switch (dtype) {
    case kF32:
      return launch_fma<PAGED>(q, k, v, lens, table, o, l, G, scale, soft_cap, st);
    case kBF16:
      return launch_mma_dp<PAGED, bf16>(q, k, v, lens, table, nullptr, nullptr, o, l, G,
                                        scale, soft_cap, st);
  }
  // a one-byte cache: contiguous only, as the reference's quantized verify
  if constexpr (!PAGED) {
    if (dtype == kI8)
      return launch_mma_dp<false, int8_t>(q, k, v, lens, table, ks, vs, o, l, G, scale,
                                          soft_cap, st);
    if (dtype == kFP8)
      return launch_mma_dp<false, fp8>(q, k, v, lens, table, ks, vs, o, l, G, scale,
                                       soft_cap, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// k_scale / v_scale: f32 row scales of a one-byte cache (dtype kI8, kFP8),
// null for a float one.
extern "C" int tdt_flash_verify(const void* q, const void* k, const void* v,
                                const void* kv_lens, const void* k_scale, const void* v_scale,
                                void* out, void* lse, int dtype, int b, int S, int hq,
                                int h_kv, int d, int s_len, float scale, float soft_cap,
                                void* stream) {
  const Geo G{b, S, hq, h_kv, 1, d, s_len, 1, 1};
  return launch<false>(q, k, v, kv_lens, nullptr, k_scale, v_scale, out, lse, dtype, G, scale,
                       soft_cap, stream);
}

// K13 over a bf16 contiguous cache on the wgmma + TMA engine
// (verify_sm90_kernel): d a multiple of 8 up to 256, q, k and v 16-byte
// aligned (the host routes other operands to tdt_flash_verify).
extern "C" int tdt_flash_verify_sm90(const void* q, const void* k, const void* v,
                                     const void* kv_lens, void* out, void* lse, int b, int S,
                                     int hq, int h_kv, int d, int s_len, float scale,
                                     float soft_cap, void* stream) {
  Geo G{b, S, hq, h_kv, 1, d, s_len, 1, 1};
  const bool aligned = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  if (h_kv <= 0 || hq % h_kv != 0 || d < 8 || d % 8 != 0 || d > 256 || b < 1 || S < 1 ||
      s_len < 0 || !aligned || static_cast<long long>(b) * h_kv * s_len >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  G.g = hq / h_kv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *o = static_cast<float*>(out), *l = static_cast<float*>(lse);
  switch (pow2_at_least(d, 64)) {
    case 64: return launch_sm90_rows<64>(q, k, v, kv_lens, o, l, G, scale, soft_cap, st);
    case 128: return launch_sm90_rows<128>(q, k, v, kv_lens, o, l, G, scale, soft_cap, st);
    default: return launch_sm90_rows<256>(q, k, v, kv_lens, o, l, G, scale, soft_cap, st);
  }
}

extern "C" int tdt_paged_flash_verify(const void* q, const void* k, const void* v,
                                      const void* kv_lens, const void* table,
                                      const void* k_scale, const void* v_scale, void* out,
                                      void* lse, int dtype, int b, int S, int hq, int h_kv,
                                      int d, int page, int max_pages, float scale,
                                      float soft_cap, void* stream) {
  const Geo G{b, S, hq, h_kv, 1, d, page * max_pages, page, max_pages};
  return launch<true>(q, k, v, kv_lens, table, k_scale, v_scale, out, lse, dtype, G, scale,
                      soft_cap, stream);
}

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
