// K2 · flash decode and K3 · paged flash decode: one query token per
// sequence attends its KV cache with grouped-query heads, returning
// (out f32 [b, hq, d], lse f32 [b, hq]).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };
typedef __nv_bfloat16 bf16;

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
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

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
// head-dim columns of the P.V accumulator for every query head.
template <typename T, bool PAGED>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kv_lens, const int* __restrict__ table,
    float* __restrict__ out_part, float* __restrict__ lse_part, int b, int hq,
    int h_kv, int d, int dp, int s_len, int page, int max_pages, int chunk,
    float scale, float soft_cap, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = hq / h_kv;
  const int ld = dp + 16 / (int)sizeof(T);  // +16 bytes staggers banks
  float* q_s = reinterpret_cast<float*>(smem);  // [g][dp]
  float* p_s = q_s + g * dp;                     // [g][TILE]
  float* m_s = p_s + g * TILE;                   // [g]
  float* l_s = m_s + g;
  float* alpha_s = l_s + g;
  T* k_s = reinterpret_cast<T*>(
      smem + ((((size_t)g * (dp + TILE + 3)) * sizeof(float) + 15) / 16) * 16);
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

  const T* qb = q + ((int64_t)bi * hq + (int64_t)h * g) * d;
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
#pragma unroll
      for (int i = 0; i < HALF_G; ++i) {
        const int j = half + 2 * i;
        if (j < g) {
          float sc = s[i] * scale;
          if (soft_cap > 0.f) sc = soft_cap * tanhf(sc / soft_cap);
          p_s[j * TILE + p_own] = p_own < nt ? sc : -INFINITY;
        }
      }
    }
    __syncthreads();
    // (b) online-softmax update of each query head's (m, l); p_s becomes
    // the tile's probabilities exp(s - m_safe)
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

template <typename T, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* kv_lens,
           const void* table, float* out_part, float* lse_part, float* out,
           float* lse, int b, int hq, int h_kv, int d, int dp, int s_len,
           int page, int max_pages, int splits, int chunk, float scale,
           float soft_cap, cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
  const int g = hq / h_kv;
  if (g > MAX_G || dp % E != 0 || dp > 2 * THREADS || dp < d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ld = dp + E;
  const size_t smem = (((size_t)g * (dp + TILE + 3)) * sizeof(float) + 15) / 16 * 16 +
                      2 * (size_t)TILE * ld * sizeof(T);
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
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_lens), static_cast<const int*>(table), out_part,
      lse_part, b, hq, h_kv, d, dp, s_len, page, max_pages, chunk, scale, soft_cap,
      vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<<<b * hq, THREADS, 0, s>>>(out_part, lse_part, out, lse,
                                                   splits, b * hq, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tdt_flash_decode(const void* q, const void* k, const void* v,
                                const void* kv_lens, void* out_part,
                                void* lse_part, void* out, void* lse, int dtype,
                                int b, int hq, int h_kv, int d, int dp,
                                int s_len, int splits, int chunk, float scale,
                                float soft_cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *op = static_cast<float*>(out_part), *lp = static_cast<float*>(lse_part);
  float *o = static_cast<float*>(out), *l = static_cast<float*>(lse);
  if (dtype == kBF16)
    return launch<bf16, false>(q, k, v, kv_lens, nullptr, op, lp, o, l, b, hq, h_kv, d, dp,
                               s_len, 1, 1, splits, chunk, scale, soft_cap, s);
  if (dtype == kF32)
    return launch<float, false>(q, k, v, kv_lens, nullptr, op, lp, o, l, b, hq, h_kv, d, dp,
                                s_len, 1, 1, splits, chunk, scale, soft_cap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int tdt_paged_flash_decode(const void* q, const void* k, const void* v,
                                      const void* kv_lens, const void* table,
                                      void* out_part, void* lse_part, void* out,
                                      void* lse, int dtype, int b, int hq,
                                      int h_kv, int d, int dp, int page,
                                      int max_pages, int splits, int chunk,
                                      float scale, float soft_cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *op = static_cast<float*>(out_part), *lp = static_cast<float*>(lse_part);
  float *o = static_cast<float*>(out), *l = static_cast<float*>(lse);
  const int s_len = page * max_pages;
  if (dtype == kBF16)
    return launch<bf16, true>(q, k, v, kv_lens, table, op, lp, o, l, b, hq, h_kv, d, dp,
                              s_len, page, max_pages, splits, chunk, scale, soft_cap, s);
  if (dtype == kF32)
    return launch<float, true>(q, k, v, kv_lens, table, op, lp, o, l, b, hq, h_kv, d, dp,
                               s_len, page, max_pages, splits, chunk, scale, soft_cap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
