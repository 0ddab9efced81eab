// K8 · grouped GEMM over block-aligned expert rows:
//   out[i*bm:(i+1)*bm] = act?(a_sorted[i*bm:(i+1)*bm]) . b[expert_ids[i]]
// with an f32 accumulator, the result cast to the output type. a_sorted
// [t_pad, k] row-major in bf16 or f32, b [n_exp, k, n], expert_ids
// [t_pad / bm] int32 read on the device (no host sync), out [t_pad, n] in
// bf16 or f32. The optional activation is the tanh GELU, applied to each
// A element in f32 and rounded back to A's type before the MMA.
//
// Replaces the TPU kernel triton_dist_tpu/ops/gg_pipeline.py:87
// make_group_gemm_kernel (bf16, padded rows), launched by
// triton_dist_tpu/ops/group_gemm.py:299 _group_gemm_fused; its act_fn
// epilogue->producer fusion is gg_pipeline.py:116-121. Padded blocks are
// computed as real rows of their (clamped) expert, as on the TPU.
//
// What bounds it on the H100: at the MoE prefill shapes (t_pad in the
// thousands, k and n in the thousands) each expert's weight panel is read
// once per M tile of that expert and multiplied by 128 rows, above the
// card's ~295 FLOP/byte ridge: tensor-core throughput, plus the GELU's
// CUDA-core work on the A tile when it is fused.
//
// What the design does about it: each M tile of 128 rows lies inside one
// expert's block (block_m is a multiple of 128), so a block tile is a K1
// tile (csrc/gemm_core.cuh: mma.sync m16n8k16, ldmatrix, three-stage
// cp.async ring) whose B base pointer is picked by that block's expert id.
// The GELU runs once per A element per N tile, in shared memory between
// the tile's arrival and its MMA, which costs one extra __syncthreads per
// k step; the A tile is re-read from L2 for each N tile. An expert-major
// schedule that keeps B panels resident, wgmma and TMA are later work.

#include "gemm_core.cuh"

namespace {

using namespace tdt;

template <class E, typename TOut, bool ACT>
__global__ void __launch_bounds__(E::THREADS, 1)
    group_gemm_kernel(const typename E::TIn* __restrict__ a,
                      const typename E::TIn* __restrict__ b, TOut* __restrict__ c, int m,
                      int n, int k, int vec, Groups g) {
  const int m0 = blockIdx.y * E::BM, n0 = blockIdx.x * E::BN;
  const AddList<TOut> none = {};
  typename E::Acc acc;
  E::template mainloop<ACT>(a, b + g.b_offset(m0, k, n), m, n, k, m0, n0, vec, acc);
  E::template store<false>(acc, c, m, n, m0, n0, none);
}

template <class E, typename TOut, bool ACT>
cudaError_t launch(const void* a, const void* b, void* c, int m, int n, int k, int vec,
                   const Groups& g, cudaStream_t s) {
  if (E::SMEM_BYTES > 0) {
    cudaError_t attr = cudaFuncSetAttribute(group_gemm_kernel<E, TOut, ACT>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            E::SMEM_BYTES);
    if (attr != cudaSuccess) return attr;
  }
  const dim3 grid(cdiv(n, E::BN), m / E::BM);
  group_gemm_kernel<E, TOut, ACT><<<grid, E::THREADS, E::SMEM_BYTES, s>>>(
      static_cast<const typename E::TIn*>(a), static_cast<const typename E::TIn*>(b),
      static_cast<TOut*>(c), m, n, k, vec, g);
  return cudaSuccess;
}

}  // namespace

// a [m, k], b [n_exp, k, n], expert_ids int32 [m / block_m], c [m, n];
// block_m a multiple of 128 that divides m; act 1 = tanh GELU on A.
extern "C" int tdt_group_gemm(const void* a, const void* b, const void* expert_ids, void* c,
                              int m, int n, int k, int n_exp, int block_m, int in_dtype,
                              int out_dtype, int act, void* stream) {
  if (block_m <= 0 || block_m % 128 != 0 || m % block_m != 0 || n_exp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Groups g = {static_cast<const int*>(expert_ids), block_m, n_exp};
  cudaError_t err = dispatch_dtypes(in_dtype, out_dtype, [&](auto e, auto t) {
    using E = decltype(e);
    using TOut = decltype(t);
    const int vec = in_dtype == kBF16 ? bf16_vec_ok(a, b, n, k) : 0;
    return act ? launch<E, TOut, true>(a, b, c, m, n, k, vec, g, s)
               : launch<E, TOut, false>(a, b, c, m, n, k, vec, g, s);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
