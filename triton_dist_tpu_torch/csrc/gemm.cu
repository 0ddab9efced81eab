// K1 · dense GEMM: C[M,N] = A[M,K] · B[K,N], f32 accumulator, the result
// cast to the output type. Row-major, contiguous A, B and C.
//
// Replaces the TPU kernels triton_dist_tpu/ops/common.py:523
// gemm_only._kernel (body gemm_add_pipeline, :468, with n_adds = 0 on the
// served path) and triton_dist_tpu/ops/gemm.py:24 _matmul_kernel, which
// compute the same function.
//
// What bounds it on the H100: at the prefill shapes (M = batch x bucket
// rows of a few hundred to a few thousand, K and N in the thousands) the
// product does about M FLOPs for every byte of the bf16 weight panel it
// reads, above the card's ~295 FLOP/byte ridge, so it is bound by
// tensor-core throughput.
//
// What the design does about it: bf16 inputs run on the tensor cores as
// m16n8k16 mma.sync with ldmatrix fragment loads, on a 128x256 block tile
// with a 64-deep k step: 8 warps each own a 64x64 sub-tile (32 MMA tiles
// fed by 8 fragment loads per 16-deep step), and a three-stage cp.async
// ring keeps two k tiles streaming into shared memory while the current
// one multiplies. f32 inputs run a shared-memory-tiled FMA kernel in full
// f32 (no TF32), the reference precision. Ragged edges are zero-filled on
// load and masked on store. wgmma, TMA multicast and a persistent tile
// scheduler are left to later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };
typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------- bf16 ----
constexpr int BM = 128, BN = 256, BK = 64, THREADS = 256, STAGES = 3;
constexpr int A_LD = BK + 8;  // padded smem rows (bf16 elements): 144- and
constexpr int B_LD = BN + 8;  // 528-byte rows put the 8 rows an ldmatrix
                              // reads in 8 different bank groups
constexpr int WM = 64, WN = 64;           // warp tile; 2 x 4 warps
constexpr int MT = WM / 16, NT = WN / 8;  // m16n8k16 tiles per warp: 4 x 8
constexpr int A_STAGE = BM * A_LD, B_STAGE = BK * B_LD;  // elements
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;

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

// One 8-element chunk of a row-major [rows, cols] matrix into shared
// memory. `vec` (cols a multiple of 8, 16-byte aligned base) lets a whole
// chunk ride cp.async; a chunk past the edge is zero-filled. Without `vec`
// every element is loaded with its own bounds check.
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* __restrict__ src,
                                           int r, int c, int rows, int cols,
                                           bool vec) {
  if (vec) {
    if (r < rows && c < cols) {
      cp_async16(dst, src + (size_t)r * cols + c);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    dst[e] = (r < rows && c + e < cols) ? src[(size_t)r * cols + c + e]
                                        : __float2bfloat16(0.f);
  }
}

// Stage the k tile at k0: A[m0:m0+BM, k0:k0+BK] (1024 chunks of 8, four
// per thread) and B[k0:k0+BK, n0:n0+BN] (2048 chunks, eight per thread).
__device__ __forceinline__ void load_tile(bf16* as, bf16* bs,
                                          const bf16* __restrict__ a,
                                          const bf16* __restrict__ b, int m,
                                          int n, int k, int m0, int n0, int k0,
                                          bool vec) {
#pragma unroll
  for (int i = 0; i < BM * BK / 8 / THREADS; ++i) {
    const int chunk = threadIdx.x + i * THREADS;
    const int r = chunk / (BK / 8), c = (chunk % (BK / 8)) * 8;
    load_chunk(as + r * A_LD + c, a, m0 + r, k0 + c, m, k, vec);
  }
#pragma unroll
  for (int i = 0; i < BK * BN / 8 / THREADS; ++i) {
    const int chunk = threadIdx.x + i * THREADS;
    const int r = chunk / (BN / 8), c = (chunk % (BN / 8)) * 8;
    load_chunk(bs + r * B_LD + c, b, k0 + r, n0 + c, k, n, vec);
  }
}

template <typename TOut>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                     TOut* __restrict__ c, int m, int n, int k, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);  // [STAGES][BM][A_LD]
  bf16* bs = as + STAGES * A_STAGE;          // [STAGES][BK][B_LD]

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (k + BK - 1) / BK;
  // prologue: STAGES-1 tiles in flight (a group is committed even when
  // empty, so the wait counts below stay uniform)
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_tile(as + st * A_STAGE, bs + st * B_STAGE, a, b, m, n, k, m0, n0, st * BK, vec);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    // tile kt has landed for every thread, and every warp has finished
    // reading the stage the next prefetch overwrites (tile kt - 1's)
    __syncthreads();
    const int pre = kt + STAGES - 1;
    if (pre < nk) {
      const int ps = pre % STAGES;
      load_tile(as + ps * A_STAGE, bs + ps * B_STAGE, a, b, m, n, k, m0, n0, pre * BK, vec);
    }
    cp_async_commit();
    const bf16* at = as + (kt % STAGES) * A_STAGE;
    const bf16* bt = bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[MT][4], bfr[NT][2];
      // A: lanes 0-15 address rows 0-15 at k kk, lanes 16-31 the same rows
      // at kk + 8 -> the four 8x8 pieces of a row-major m16k16 fragment
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], at + (wm * WM + i * 16 + lane % 16) * A_LD + kk + (lane / 16) * 8);
      // B is [k][n] in shared memory: transposing loads of k rows 0-7 /
      // 8-15 at n and n + 8 give two n8 tiles' column-major k16 fragments
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned r[4];
        ldmatrix_x4_trans(r, bt + (kk + lane % 8 + ((lane / 8) % 2) * 8) * B_LD +
                                 wn * WN + j * 8 + (lane / 16) * 8);
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: thread holds rows lane/4 and lane/4 + 8, columns
  // 2*(lane%4) and +1, of each m16n8 tile; the ragged edge is masked
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = m0 + wm * WM + i * 16 + lane / 4;
      const int col = n0 + wn * WN + j * 8 + (lane % 4) * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = r + (e / 2) * 8, cc = col + e % 2;
        if (rr < m && cc < n) c[(size_t)rr * n + cc] = from_f32<TOut>(acc[i][j][e]);
      }
    }
  }
}

// ----------------------------------------------------------------- f32 ----
constexpr int FT = 64, FK = 16;  // 64x64 tile, 16-deep k step; 4x4 per thread

template <typename TOut>
__global__ void __launch_bounds__(256)
    gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    TOut* __restrict__ c, int m, int n, int k) {
  __shared__ float as[FK][FT + 4];  // transposed: as[kk][row]
  __shared__ float bs[FK][FT + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * FT, n0 = blockIdx.x * FT;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += FK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256;
      const int ra = e / FK, ka = e % FK;
      as[ka][ra] = (m0 + ra < m && k0 + ka < k) ? a[(size_t)(m0 + ra) * k + k0 + ka] : 0.f;
      const int kb = e / FT, cb = e % FT;
      bs[kb][cb] = (k0 + kb < k && n0 + cb < n) ? b[(size_t)(k0 + kb) * n + n0 + cb] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (r < m && col < n) c[(size_t)r * n + col] = from_f32<TOut>(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" int tdt_gemm(const void* a, const void* b, void* c, int m, int n,
                        int k, int in_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kBF16) {
    const int vec = (k % 8 == 0) && (n % 8 == 0) &&
                    (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(b) % 16 == 0);
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    const bf16* pa = static_cast<const bf16*>(a);
    const bf16* pb = static_cast<const bf16*>(b);
    if (out_dtype == kBF16) {
      cudaError_t err = cudaFuncSetAttribute(
          gemm_bf16_kernel<bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
      if (err != cudaSuccess) return static_cast<int>(err);
      gemm_bf16_kernel<bf16><<<grid, THREADS, SMEM_BYTES, s>>>(
          pa, pb, static_cast<bf16*>(c), m, n, k, vec);
    } else if (out_dtype == kF32) {
      cudaError_t err = cudaFuncSetAttribute(
          gemm_bf16_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
      if (err != cudaSuccess) return static_cast<int>(err);
      gemm_bf16_kernel<float><<<grid, THREADS, SMEM_BYTES, s>>>(
          pa, pb, static_cast<float*>(c), m, n, k, vec);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (in_dtype == kF32) {
    const dim3 grid((n + FT - 1) / FT, (m + FT - 1) / FT);
    const float* pa = static_cast<const float*>(a);
    const float* pb = static_cast<const float*>(b);
    if (out_dtype == kF32) {
      gemm_f32_kernel<float><<<grid, 256, 0, s>>>(pa, pb, static_cast<float*>(c), m, n, k);
    } else if (out_dtype == kBF16) {
      gemm_f32_kernel<bf16><<<grid, 256, 0, s>>>(pa, pb, static_cast<bf16*>(c), m, n, k);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
