// K1's bf16 engine for Hopper (csrc/gemm.cu): a warp-specialised, persistent
// wgmma + TMA GEMM. C[M,N] = A[M,K] . B[K,N] (+ the epilogue adds of
// gemm_add_pipeline, triton_dist_tpu/ops/common.py:468), bf16 in, f32
// accumulate, one cast to the output type.
//
// What bounds K1 on the H100: at the prefill shapes (M in the thousands) the
// product is above the ~295 FLOP/byte ridge, so tensor-core throughput; at
// the decode shapes (M = batch, 8) it reads each weight once for ~16 FLOPs,
// so the bytes of B. mma.sync (the Bf16Engine of gemm_core.cuh) cannot reach
// Hopper's tensor-core rate, and its threads spend registers and
// instructions on load addresses.
//
// What this design does about it:
// - Loads: the Tensor Memory Accelerator. One thread issues each k step's
//   A box ([BM rows][64 k], one copy) and B boxes ([64 k][64 n], BN / 64
//   copies) into 128-byte-swizzled shared memory; they complete on the
//   stage's "full" mbarrier. Boxes past the matrix edge land zero-filled.
//   The tensor maps are encoded on the host (cuTensorMapEncodeTiled, reached
//   through cudaGetDriverEntryPoint, so no link flag) and passed as
//   __grid_constant__ parameters.
// - Warp roles: warpgroup 0 is the producer (one thread issues TMA, the
//   warpgroup gives its registers back with setmaxnreg.dec); warpgroups 1..WGS
//   are consumers (setmaxnreg.inc), each owning 64 rows of the BM x BN tile
//   and issuing wgmma.mma_async m64nBNk16 from shared memory: A K-major, B
//   MN-major (B is row-major [K, N] in device memory, read as is). A consumer
//   warp releases a stage on its "empty" mbarrier once its wgmma group has
//   completed. STAGES stages fill the shared memory.
// - Grid: persistent, one block per SM (grid = min(tiles, SMs), computed on
//   the host), walking the output tiles in a grouped raster (GROUP_M row
//   tiles a group, so concurrent tiles share their B panels in L2). The
//   producer runs ahead into the next tile while the consumers store this
//   one's epilogue.
// - Epilogue: K1's contract exactly: the n_adds f32 adds summed after the
//   last k step in the order given, one cast, the ragged M and N edges
//   masked on store (two neighbouring columns a store).
// - Small M: a 64-row tile with one consumer warpgroup and a 64-wide N tile
//   (config 2), so a product of at most 64 rows spreads its weight panel
//   over the SMs; the host picks the config by shape (ops/gemm.py::plan).
//
// TMA needs 16-byte row strides and bases: bf16 K and N multiples of 8 and
// 16-byte aligned pointers. The host routes other products to the mma.sync
// engine.

#pragma once

#include "gemm_core.cuh"
#include "sm90.cuh"

namespace tdt {
namespace sm90 {

constexpr int BK = 64;        // k depth of a stage: one 128-byte swizzle row of bf16
constexpr int BOX_N = 64;     // B box width (n): one 128-byte swizzle row
constexpr int GROUP_M = 8;    // row tiles of one raster group
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;

// --------------------------------------------------------------- the tile ----
template <int WGS, int BN, int STAGES>
struct Tile {
  static_assert(BN == 64 || BN == 128 || BN == 256, "wgmma n of 64, 128 or 256");
  static constexpr int BM = 64 * WGS;
  static constexpr int THREADS = 128 * (WGS + 1);
  static constexpr int A_STAGE = BM * BK;   // elements
  static constexpr int B_STAGE = BK * BN;
  static constexpr uint32_t STAGE_BYTES = (A_STAGE + B_STAGE) * 2;
  // the stages, then the full and empty barriers; +1024 to align the base
  static constexpr size_t SMEM_BYTES =
      static_cast<size_t>(STAGES) * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t) + 1024;
  static_assert(SMEM_BYTES <= 232448, "fits a block's shared memory");
};

// output tile t of an (mt x nt) grid in the grouped raster
__device__ __forceinline__ void tile_coords(int t, int mt, int nt, int& tm, int& tn) {
  const int span = GROUP_M * nt;
  const int first = (t / span) * GROUP_M;
  const int rows = min(mt - first, GROUP_M);
  const int local = t % span;
  tm = first + local % rows;
  tn = local / rows;
}

// two neighbouring output columns (cc even, n even: both in range together)
template <bool ADDS, typename TOut>
__device__ __forceinline__ void store_pair(TOut* __restrict__ c, int n, int rr, int cc, float v0,
                                           float v1, const AddList<TOut>& adds) {
  const size_t at = static_cast<size_t>(rr) * n + cc;
  if (ADDS) {
#pragma unroll
    for (int t = 0; t < MAX_ADDS; ++t) {
      if (t < adds.n) {
        v0 += to_f32<TOut>(adds.p[t][at]);
        v1 += to_f32<TOut>(adds.p[t][at + 1]);
      }
    }
  }
  if constexpr (sizeof(TOut) == 2) {
    *reinterpret_cast<__nv_bfloat162*>(c + at) = __floats2bfloat162_rn(v0, v1);
  } else {
    *reinterpret_cast<float2*>(c + at) = make_float2(v0, v1);
  }
}

template <int WGS, int BN, int STAGES, typename TOut, bool ADDS>
__global__ void __launch_bounds__(Tile<WGS, BN, STAGES>::THREADS, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, TOut* __restrict__ c, int m,
                     int n, int k, AddList<TOut> adds) {
  using T = Tile<WGS, BN, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles want 1024-byte aligned stages
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sa = reinterpret_cast<bf16*>(base);
  bf16* sb = sa + STAGES * T::A_STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * T::B_STAGE);
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * WGS);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int mt = cdiv(m, T::BM), nt = cdiv(n, BN), tiles = mt * nt, nk = cdiv(k, BK);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------- producer ----
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int tm, tn;
        tile_coords(t, mt, nt, tm, tn);
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(empty + stage, phase ^ 1);
          mbar_expect_tx(full + stage, T::STAGE_BYTES);
          tma_load_2d(sa + stage * T::A_STAGE, &map_a, kt * BK, tm * T::BM, full + stage);
#pragma unroll
          for (int bx = 0; bx < BN / BOX_N; ++bx)
            tma_load_2d(sb + stage * T::B_STAGE + bx * BK * BOX_N, &map_b, tn * BN + bx * BOX_N,
                        kt * BK, full + stage);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers ----
    reg_alloc<CONSUMER_REGS>();
    const int cw = wg - 1, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int tm, tn;
      tile_coords(t, mt, nt, tm, tn);
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(full + stage, phase);
        const bf16* at = sa + stage * T::A_STAGE + cw * 64 * BK;
        const bf16* bt = sb + stage * T::B_STAGE;
        fence_acc<BN / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wgmma_step<BN>(acc, smem_desc(at + kk * 16, KMAJOR_LBO, KMAJOR_SBO),
                         smem_desc(bt + kk * 16 * BOX_N, MNMAJOR_LBO, MNMAJOR_SBO),
                         kt > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc<BN / 2>(acc);
        if (lane == 0) mbar_arrive(empty + stage);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      // epilogue: thread holds rows lane/4 and lane/4 + 8 of its warp's 16,
      // columns 2 * (lane % 4) and + 1 of every 8-wide block
      const int r0 = tm * T::BM + cw * 64 + warp * 16 + lane / 4;
      const int c0 = tn * BN + (lane % 4) * 2;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        const int cc = c0 + nb * 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = r0 + 8 * h;
          if (rr < m && cc < n)
            store_pair<ADDS>(c, n, rr, cc, acc[nb * 4 + 2 * h], acc[nb * 4 + 2 * h + 1], adds);
        }
      }
    }
  }
}

template <int WGS, int BN, int STAGES, typename TOut, bool ADDS>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb, TOut* c, int m, int n, int k,
                   const AddList<TOut>& adds, int grid, cudaStream_t s) {
  using T = Tile<WGS, BN, STAGES>;
  auto kernel = gemm_sm90_kernel<WGS, BN, STAGES, TOut, ADDS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::SMEM_BYTES));
  if (err != cudaSuccess) return err;
  kernel<<<grid, T::THREADS, T::SMEM_BYTES, s>>>(ma, mb, c, m, n, k, adds);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace tdt
