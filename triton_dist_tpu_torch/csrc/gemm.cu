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
// tensor-core throughput; at decode (M = batch) by the bytes of B.
//
// Three engines, chosen on the host by dtype, shape and alignment
// (ops/gemm.py::plan):
// - tdt_gemm_sm90, bf16 with K and N multiples of 8 and 16-byte aligned
//   pointers: the warp-specialised persistent wgmma + TMA kernel of
//   gemm_sm90.cuh (its source note says how it meets the bound), in one of
//   three tile configs (128x256, 128x128, and 64x64 for small M).
// - tdt_gemm, bf16 otherwise: the m16n8k16 mma.sync Bf16Engine of
//   gemm_core.cuh (128x256x64 block tile, 8 warps, a three-stage cp.async
//   ring, one block a tile), which loads unaligned rows element by element.
// - tdt_gemm, f32: a shared-memory-tiled FMA kernel in full f32 (no TF32),
//   the reference precision.
// Ragged edges are zero-filled on load and masked on store in all three.

#include "gemm_core.cuh"
#include "gemm_sm90.cuh"

#include <type_traits>

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

// The wgmma + TMA engine (bf16 in). map_a / map_b: the tensor-map arguments
// of A and B, {dim0 (innermost), dim1, outer stride in bytes, box0, box1},
// as ops/gemm.py::plan computes them; config picks the tile (0: 128x256, 1:
// 128x128, 2: 64x64) and must agree with the boxes; grid is the persistent
// block count (<= the SMs).
extern "C" int tdt_gemm_sm90(const void* a, const void* b, void* c, int m, int n, int k,
                             int out_dtype, const void* const* adds, int n_adds, int config,
                             int grid, const long long* map_a, const long long* map_b,
                             void* stream) {
  if (n_adds < 0 || n_adds > MAX_ADDS || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  static const int kBM[3] = {128, 128, 64};
  if (config < 0 || config > 2 || map_a[3] != sm90::BK || map_a[4] != kBM[config] ||
      map_b[3] != sm90::BOX_N || map_b[4] != sm90::BK)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  cudaError_t err = sm90::make_map(&ma, a, map_a, map_a[2], map_a + 3);
  if (err == cudaSuccess) err = sm90::make_map(&mb, b, map_b, map_b[2], map_b + 3);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto t) -> cudaError_t {
    using TOut = decltype(t);
    const AddList<TOut> list = make_adds<TOut>(adds, n_adds);
    TOut* out = static_cast<TOut*>(c);
    auto run = [&](auto adds_on) -> cudaError_t {
      constexpr bool ADDS = decltype(adds_on)::value;
      switch (config) {
        case 0: return sm90::launch<2, 256, 4, TOut, ADDS>(ma, mb, out, m, n, k, list, grid, s);
        case 1: return sm90::launch<2, 128, 6, TOut, ADDS>(ma, mb, out, m, n, k, list, grid, s);
        default: return sm90::launch<1, 64, 8, TOut, ADDS>(ma, mb, out, m, n, k, list, grid, s);
      }
    };
    return n_adds > 0 ? run(std::true_type{}) : run(std::false_type{});
  };
  if (out_dtype == kBF16) err = go(bf16{});
  else if (out_dtype == kF32) err = go(float{});
  else err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
