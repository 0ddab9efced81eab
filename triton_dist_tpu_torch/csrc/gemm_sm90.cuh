// K1's bf16 engine for Hopper (csrc/gemm.cu): a warp-specialised, persistent
// wgmma + TMA GEMM. C[M,N] = A[M,K] . B[K,N] (+ the epilogue adds of
// gemm_add_pipeline, triton_dist_tpu/ops/common.py:468), bf16 in, f32
// accumulate, one cast to the output type. Its mainloop (gemm_sm90_body)
// is also K6's (csrc/dist.cu ag_gemm_sm90_kernel, a walk that waits for
// each gathered shard), K7's (dist.cu gemm_rs_producer_kernel, a walk over
// the peers' chunks whose epilogue stores into their landing slots;
// gemm_rs_sm90_kernel, the own chunk with a wait for the landed chunks
// before its first epilogue), K8/K29's (csrc/group_gemm.cu
// group_gemm_sm90_kernel, a walk over the live row tiles of expert blocks,
// B a 3-D map over the bank) and the rings' K15 and K16/K17 (csrc/ring.cu
// ring_ag_gemm_sm90_kernel, a step walk over two A maps whose producer
// warpgroup's idle warps forward the shards; ring_gemm_rs_sm90_kernel, a
// step walk that waits for the left neighbour's partial before each
// (step, span)'s epilogue and stores into the right neighbour's slot).
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

#include <type_traits>

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

// An output tile of the walk: row tile tm and column tile tn of slab
// `slab` (K1 has one slab; K6's slabs are the gathered shards, slab c's rows
// at out + c * m * n), B's slab `expert` (a grouped walk), and the row at
// or past which the tile's rows are stored as zeros (a ragged walk; a tile
// whose first row is at or past it is dead: no loads, zero stores). A walk
// over spans of a slab's rows (the rings) counts its row tiles from `off`
// and stores no row at or past `end`; `step` and `span` name the ring step
// and the span the tile belongs to.
struct Coord {
  int tm, tn, slab = 0, expert = 0, rows_end = 0x7fffffff;
  int off = 0, end = 0x7fffffff, step = 0, span = 0;
};

// What a walk may ask of the body, all off by default (a walk derives from
// this and turns on what it needs):
// - SLABS: A is a 3-D map over [slabs, m, k] (K6's shards, K7's chunks);
// - B_SLABS: B is a 3-D map over [slabs, k, n], the tile's `expert` slab;
// - CAN_ABORT: a wait of the walk can expire (the producer's ready(), or the
//   consumers' landed()): from then on the block skips products and stores;
// - RAGGED: rows_end bounds the live rows; a dead tile is neither loaded nor
//   multiplied, its rows stored as zeros;
// - SIGNALS: stored(x) runs on every consumer thread after a tile's stores
//   (and, once a wait has expired, in their place, so that a peer waiting
//   on the tile's signal is released);
// - EPI_WAIT: landed(x) runs on every consumer thread before each epilogue,
//   after the tile's k loop (the walk decides which tiles wait);
// - SIDE_WORK: side_work(tid, threads) runs on the producer warpgroup's
//   three idle warps (tid 0 .. threads - 1), beside the producer thread.
struct WalkBase {
  static constexpr bool SLABS = false, B_SLABS = false, CAN_ABORT = false, RAGGED = false,
                        SIGNALS = false, EPI_WAIT = false, SIDE_WORK = false;
  // the producer thread, before a tile's first load: false aborts the block
  __device__ __forceinline__ bool ready(const Coord&) { return true; }
  // the A map tile x is loaded from (a walk over two A operands picks one)
  __device__ __forceinline__ const CUtensorMap* a_map(const Coord&,
                                                      const CUtensorMap* map) const {
    return map;
  }
  // where tile x's output rows live: slab x.slab of [slabs, m, n]
  template <typename TOut>
  __device__ __forceinline__ TOut* out(TOut* c, const Coord& x, int m, int n) const {
    return c + static_cast<size_t>(x.slab) * m * n;
  }
  // the f32 adds of tile x's epilogue, indexed as its output slab
  template <typename TOut>
  __device__ __forceinline__ AddList<TOut> adds(const Coord&, const AddList<TOut>& a) const {
    return a;
  }
  __device__ __forceinline__ void stored(const Coord&) const {}
  __device__ __forceinline__ bool landed(const Coord&) { return true; }
  __device__ __forceinline__ void side_work(int, int) {}
};

// the consumer warpgroups' own named barrier (id 1), and the side work's
// (id 2, its three warps): the body uses no other
template <int WGS> __device__ __forceinline__ void consumers_sync() {
  named_barrier(1, 128 * WGS);
}
constexpr int SIDE_BAR = 2, SIDE_THREADS = 96;

// K1's walk: the grouped raster over one [m, n] output; A is a 2-D map.
struct Raster : WalkBase {
  int mt, nt;
  __device__ __forceinline__ int tiles() const { return mt * nt; }
  __device__ __forceinline__ Coord at(int t) const {
    Coord c;
    tile_coords(t, mt, nt, c.tm, c.tn);
    return c;
  }
};

// The mainloop and epilogue a block runs over the tiles `walk` gives it
// (blockIdx.x, + gridDim.x, ...): K1 with a Raster, K6 and K7 (csrc/dist.cu)
// with their walks, K8/K29 (csrc/group_gemm.cu) with theirs. m is the rows
// of one slab.
//
// A walk whose waits can expire (CAN_ABORT) stops the block's work without
// leaving a copy in flight. A producer-side wait (K6's shard flags) that
// expired returns false from ready(); the producer then sets the abort word
// and, for every stage it has left to fill, arrives on its "full" barrier
// with no copy, so no consumer waits on a barrier that never fills. Every
// consumer reads the word after each "full" wait and from then on skips the
// products and the stores, still waiting on each stage in turn: the block
// ends only once every copy it issued has landed, and soon (no loads, no
// products). An epilogue-side wait (K7's landed chunks, K16/K17's left
// partials: landed()) that expired makes the consumers skip that epilogue
// and every later product and store in the same way, while the producer's
// loads still land and are drained stage by stage; a SIGNALS walk still
// raises each skipped tile's signal. The host raises with the wait's record.
template <int WGS, int BN, int STAGES, typename TOut, bool ADDS, class Walk>
__device__ __forceinline__ void gemm_sm90_body(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                               TOut* __restrict__ c, int m, int n, int k,
                                               const AddList<TOut>& adds, Walk walk) {
  using T = Tile<WGS, BN, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles want 1024-byte aligned stages
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sa = reinterpret_cast<bf16*>(base);
  bf16* sb = sa + STAGES * T::A_STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * T::B_STAGE);
  uint64_t* empty = full + STAGES;
  volatile int* abort_word = nullptr;
  if constexpr (Walk::CAN_ABORT) {
    __shared__ int abort_s;
    abort_word = &abort_s;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * WGS);  // one arrival per consumer warp
    }
    if constexpr (Walk::CAN_ABORT) *abort_word = 0;
    mbar_init_fence();
  }
  __syncthreads();

  const int tiles = walk.tiles(), nk = cdiv(k, BK);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------- producer ----
    reg_dealloc<PRODUCER_REGS>();
    if constexpr (Walk::SIDE_WORK) {
      if (threadIdx.x >= 32) walk.side_work(threadIdx.x - 32, SIDE_THREADS);
    }
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      [[maybe_unused]] bool live = true;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Coord x = walk.at(t);
        if constexpr (Walk::RAGGED) {
          if (x.rows_end <= x.tm * T::BM) continue;  // a dead tile: nothing to load
        }
        if constexpr (Walk::CAN_ABORT) {
          if (live && !walk.ready(x)) {
            live = false;
            *abort_word = 1;  // released with the next "full" arrival
          }
        }
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(empty + stage, phase ^ 1);
          if constexpr (Walk::CAN_ABORT) {
            if (!live) {
              mbar_arrive(full + stage);
              if (++stage == STAGES) {
                stage = 0;
                phase ^= 1;
              }
              continue;
            }
          }
          mbar_expect_tx(full + stage, T::STAGE_BYTES);
          if constexpr (Walk::SLABS)
            tma_load_3d(sa + stage * T::A_STAGE, walk.a_map(x, &map_a), kt * BK,
                        x.off + x.tm * T::BM, x.slab, full + stage);
          else
            tma_load_2d(sa + stage * T::A_STAGE, walk.a_map(x, &map_a), kt * BK,
                        x.off + x.tm * T::BM, full + stage);
#pragma unroll
          for (int bx = 0; bx < BN / BOX_N; ++bx) {
            if constexpr (Walk::B_SLABS)
              tma_load_3d(sb + stage * T::B_STAGE + bx * BK * BOX_N, &map_b,
                          x.tn * BN + bx * BOX_N, kt * BK, x.expert, full + stage);
            else
              tma_load_2d(sb + stage * T::B_STAGE + bx * BK * BOX_N, &map_b,
                          x.tn * BN + bx * BOX_N, kt * BK, full + stage);
          }
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
    [[maybe_unused]] bool dead = false;  // a wait expired: skip products and stores
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Coord x = walk.at(t);
      TOut* cs = walk.out(c, x, m, n);
      if constexpr (Walk::RAGGED) {
        if (x.rows_end <= x.tm * T::BM) {
          // a dead tile: its [BM, BN] rows as zeros, two columns a store
          for (int i = threadIdx.x - 128; i < T::BM * BN / 2; i += 128 * WGS) {
            const int rr = x.tm * T::BM + i / (BN / 2), cc = x.tn * BN + (i % (BN / 2)) * 2;
            if (rr < m && cc < n) store_pair<false>(cs, n, rr, cc, 0.f, 0.f, adds);
          }
          continue;
        }
      }
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(full + stage, phase);
        if constexpr (Walk::CAN_ABORT) {
          if (dead || *abort_word) {
            dead = true;
            if (lane == 0) mbar_arrive(empty + stage);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
            continue;
          }
        }
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
      if constexpr (Walk::EPI_WAIT) {
        // every consumer thread meets here at every tile (dead is the same on all)
        if (!dead && !walk.landed(x)) dead = true;
      }
      if constexpr (Walk::CAN_ABORT) {
        if (dead) {
          if constexpr (Walk::SIGNALS) walk.stored(x);
          continue;
        }
      }
      // epilogue: thread holds rows lane/4 and lane/4 + 8 of its warp's 16,
      // columns 2 * (lane % 4) and + 1 of every 8-wide block; a ragged
      // walk's rows at or past rows_end are stored as zeros, a span walk's
      // rows at or past end not at all
      const int r0 = x.off + x.tm * T::BM + cw * 64 + warp * 16 + lane / 4;
      const int c0 = x.tn * BN + (lane % 4) * 2;
      const int r_end = min(m, x.end);
      const AddList<TOut> tile_adds = walk.adds(x, adds);
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        const int cc = c0 + nb * 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = r0 + 8 * h;
          if (rr < r_end && cc < n) {
            float v0 = acc[nb * 4 + 2 * h], v1 = acc[nb * 4 + 2 * h + 1];
            if constexpr (Walk::RAGGED) {
              if (rr >= x.rows_end) v0 = v1 = 0.f;
            }
            store_pair<ADDS>(cs, n, rr, cc, v0, v1, tile_adds);
          }
        }
      }
      if constexpr (Walk::SIGNALS) walk.stored(x);
    }
  }
}

template <int WGS, int BN, int STAGES, typename TOut, bool ADDS>
__global__ void __launch_bounds__(Tile<WGS, BN, STAGES>::THREADS, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, TOut* __restrict__ c, int m,
                     int n, int k, AddList<TOut> adds) {
  gemm_sm90_body<WGS, BN, STAGES, TOut, ADDS>(map_a, map_b, c, m, n, k, adds,
                                             Raster{{}, cdiv(m, Tile<WGS, BN, STAGES>::BM),
                                                    cdiv(n, BN)});
}

// f(BN, STAGES) for K1's two-warpgroup tile configs 0 (128x256) and 1
// (128x128), the tiles of the walks on the persistent grids (K6, K7, K15,
// K16/K17)
template <typename F>
cudaError_t with_config(int config, F&& f) {
  if (config == 0) return f(std::integral_constant<int, 256>{}, std::integral_constant<int, 4>{});
  if (config == 1) return f(std::integral_constant<int, 128>{}, std::integral_constant<int, 6>{});
  return cudaErrorInvalidValue;
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
