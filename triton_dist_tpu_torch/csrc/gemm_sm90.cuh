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

#include <cuda.h>

#include "gemm_core.cuh"

namespace tdt {
namespace sm90 {

constexpr int BK = 64;        // k depth of a stage: one 128-byte swizzle row of bf16
constexpr int BOX_N = 64;     // B box width (n): one 128-byte swizzle row
constexpr int GROUP_M = 8;    // row tiles of one raster group
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --------------------------------------------------------------- mbarrier ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// 2-D TMA load of the box at (c0 innermost, c1) into shared memory
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// ------------------------------------------------------------------ wgmma ----
// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128).
// A (K-major): rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the
// leading offset is unused inside one swizzle row. B (MN-major, [64 k][64 n]
// boxes): 8 k-rows 1024 bytes apart (SBO), the next 64 n columns one box
// (8192 bytes) further (LBO).
constexpr uint32_t A_LBO = 16, A_SBO = 1024;
constexpr uint32_t B_LBO = BK * BOX_N * 2, B_SBO = 1024;

__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16;
  d |= static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
  d |= 1ull << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator accesses across the async ops
template <int R> __device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R> __device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R> __device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// d (+)= A . B for one m64nNk16 step, bf16 in, f32 accumulate: A from its
// K-major descriptor, B from its MN-major one (imm-trans-b = 1); scale_d 0
// overwrites d (a tile's first step), 1 accumulates
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_step(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 256) wgmma_m64n256k16(d, da, db, scale_d);
  else if constexpr (BN == 128) wgmma_m64n128k16(d, da, db, scale_d);
  else wgmma_m64n64k16(d, da, db, scale_d);
}

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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
          wgmma_step<BN>(acc, smem_desc(at + kk * 16, A_LBO, A_SBO),
                         smem_desc(bt + kk * 16 * BOX_N, B_LBO, B_SBO), kt > 0 || kk > 0);
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

// ------------------------------------------------------------------- host ----
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 2-D bf16 tensor map: dims {inner, outer} elements, the outer stride in
// bytes, box {inner, outer}, 128-byte swizzle, zero fill past the edges.
inline cudaError_t make_map(CUtensorMap* map, const void* base, const long long* dims,
                            long long stride, const long long* box) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t gdim[2] = {static_cast<cuuint64_t>(dims[0]), static_cast<cuuint64_t>(dims[1])};
  const cuuint64_t gstride[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t bdim[2] = {static_cast<cuuint32_t>(box[0]), static_cast<cuuint32_t>(box[1])};
  const cuuint32_t estride[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            gdim, gstride, bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
