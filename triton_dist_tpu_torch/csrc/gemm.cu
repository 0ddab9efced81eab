// K1 · dense GEMM: C[M,N] = A[M,K] · B[K,N] (+ the epilogue adds), f32
// accumulator, the result cast to the output type. Row-major, contiguous
// A, B, C and adds.
//
// Replaces the TPU kernels triton_dist_tpu/ops/common.py:523
// gemm_only._kernel (body gemm_add_pipeline, :468, including its n_adds
// epilogue: O = A·B + Σ adds, summed in f32 after the last k step) and
// triton_dist_tpu/ops/gemm.py:24 _matmul_kernel, which compute the same
// function.
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
// load and masked on store. The tile code lives in gemm_core.cuh, shared
// with the fused AG-GEMM and GEMM-RS consumers of dist.cu. wgmma, TMA
// multicast and a persistent tile scheduler are left to later work.

#include "gemm_core.cuh"

namespace {

using namespace tdt;

template <class E, typename TOut, bool ADDS>
__global__ void __launch_bounds__(E::THREADS, 1)
    gemm_kernel(const typename E::TIn* __restrict__ a, const typename E::TIn* __restrict__ b,
                TOut* __restrict__ c, int m, int n, int k, int vec, AddList<TOut> adds) {
  const int m0 = blockIdx.y * E::BM, n0 = blockIdx.x * E::BN;
  typename E::Acc acc;
  E::mainloop(a, b, m, n, k, m0, n0, vec, acc);
  E::template store<ADDS>(acc, c, m, n, m0, n0, adds);
}

template <class E, typename TOut, bool ADDS>
cudaError_t launch(const void* a, const void* b, void* c, int m, int n, int k, int vec,
                   const AddList<TOut>& adds, cudaStream_t s) {
  if (E::SMEM_BYTES > 0) {
    cudaError_t attr = cudaFuncSetAttribute(
        gemm_kernel<E, TOut, ADDS>, cudaFuncAttributeMaxDynamicSharedMemorySize, E::SMEM_BYTES);
    if (attr != cudaSuccess) return attr;
  }
  const dim3 grid(cdiv(n, E::BN), cdiv(m, E::BM));
  gemm_kernel<E, TOut, ADDS><<<grid, E::THREADS, E::SMEM_BYTES, s>>>(
      static_cast<const typename E::TIn*>(a), static_cast<const typename E::TIn*>(b),
      static_cast<TOut*>(c), m, n, k, vec, adds);
  return cudaSuccess;
}

}  // namespace

// adds: host array of n_adds device pointers to [m, n] matrices in the
// output type (n_adds <= 7; 0 is the plain product)
extern "C" int tdt_gemm(const void* a, const void* b, void* c, int m, int n, int k,
                        int in_dtype, int out_dtype, const void* const* adds, int n_adds,
                        void* stream) {
  if (n_adds < 0 || n_adds > MAX_ADDS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch_dtypes(in_dtype, out_dtype, [&](auto e, auto t) {
    using E = decltype(e);
    using TOut = decltype(t);
    const int vec = in_dtype == kBF16 ? bf16_vec_ok(a, b, n, k) : 0;
    const AddList<TOut> list = make_adds<TOut>(adds, n_adds);
    return n_adds > 0 ? launch<E, TOut, true>(a, b, c, m, n, k, vec, list, s)
                      : launch<E, TOut, false>(a, b, c, m, n, k, vec, list, s);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
