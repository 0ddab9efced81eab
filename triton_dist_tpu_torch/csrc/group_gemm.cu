// K8 · grouped GEMM over block-aligned expert rows (K24: its scaled weight
// formats, below):
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

// K24 · K8 with int8 or fp8 e4m3 expert banks and their per-(expert,
// out-column) f32 scales (tdt_group_gemm with b_dtype int8/fp8):
//   out[i*bm:(i+1)*bm] = (act?(A_i) . upcast(b[e_i])) * scale[e_i]
// Replaces gg_pipeline.py:87 make_group_gemm_kernel under
// OperandFormat.scaled (w8, fp8), launched by triton_dist_tpu/ops/
// group_gemm.py:299 (group_gemm_w8 / group_gemm_fp8); the fold is
// gg_pipeline.py:145. What bounds it at the Mixtral prefill shapes:
// operations, as K8 (B at one byte moves ~0.47 GB, A and the output more;
// the products are the same 1.2e15-scale work) plus the B conversion on the
// CUDA cores. The design: K8's tile with gemm_core.cuh's one-byte B stager
// (16 weights a cp.async, a quarter of the bf16 stage) and a per-step
// conversion into one bf16 tile; the expert's scale row (clamped like its
// bank) multiplies the f32 accumulator in the store, before the cast and
// before anything downstream (the combine weights of K10/K26). Tensor-core
// fp8 math with a quantized A, wgmma and TMA are later work.

// K29 · K8/K24 under the ragged-row policy (tdt_group_gemm with a
// valid_rows map, bf16 / f32 A over a bank of its type, int8 or fp8):
//   out[i*bm + r] = r < valid[i] ? (act?(A_i) . B[e_i] (* scale[e_i]))[r] : 0
// Replaces gg_pipeline.py:87 make_group_gemm_kernel with ragged=True (the
// panel-guarded dots and the masked store, :110-152), launched by
// triton_dist_tpu/ops/group_gemm.py:299 with its valid_rows map.
//
// What bounds it: the live rows' products (operations, as K8) plus the
// zeros of the dead rows written once (bytes); a dead tile's CTA reads one
// int of the map and exits after its stores.
//
// What the design does about it: the grid keeps every 128-row tile of the
// padded layout (t_pad / 128 row tiles, no host sync to size it), and
// each CTA reads its block's live count first. A tile at or past it
// (gemm_core.cuh Groups::live_rows <= 0) writes zeros and returns without
// reading A or B, which is the TPU kernel's skipped panel (its panel is 128
// rows at bm >= 128, _panel_for). A live tile runs K8's mainloop unchanged,
// so its live rows are bit-equal to K8/K24's; the store writes the rows
// past the live count as zeros after the scale fold. The f32 engine's
// 64-row tiles skip at 64 rows and give the same output.

// K11 · the grouped-GEMM weight gradient (tdt_group_gemm_dw):
//   dW[e] = sum over the row blocks i with expert_ids[i] == e of A_i^T . G_i
// a_sorted [t_pad, k] and g_sorted [t_pad, n] in one type (bf16 or f32),
// block-aligned in the same order; dW [n_exp, k, n] f32; ids clamped into
// the bank; an expert with no blocks comes back exactly zero.
//
// Replaces triton_dist_tpu/ops/gg_pipeline.py:159 make_group_gemm_dw_kernel
// (non-ragged), launched by triton_dist_tpu/ops/group_gemm.py:534
// _group_gemm_dw_fused. The TPU grid walks the row blocks innermost and
// accumulates an expert's consecutive run in VMEM, so its wrapper sorts the
// blocks by expert first (two permutation copies of the operands) unless
// the caller vouches for the order.
//
// What bounds it on the H100: at the training shapes (t_pad 5120, k and n
// 4096 / 14336) the products are 6e11 operations and the f32 output 1.9 GB;
// operations (0.61 ms at the bf16 peak) and bytes (0.56 ms) are close.
//
// What the design does about it: one CTA per output tile [128 x 256] of
// dW[e] (grid: N tiles, K tiles, experts). The CTA lists its expert's row
// blocks in block order (a ballot compaction of the ids in shared memory,
// no host sync, no argsort) and runs K1's pipeline over their rows: 64
// rows a step, a three-stage cp.async ring, mma.sync m16n8k16 with the A
// fragments read transposed from the [rows, k] tile (ldmatrix.trans). The
// sum order per element is the rows of the expert's blocks in block order
// for any layout, sorted (world 1) or rank-major (world > 1), so no
// permutation copy is made. The f32 tile is written once. The f32 operands
// take the FMA tile of F32Engine (reference precision).

// K34 · K11 under the ragged-row policy (tdt_group_gemm_dw with a
// valid_rows map):
//   dW[e] = sum over the blocks i of e of A_i[:v_i]^T . G_i[:v_i]
// with v_i the block's live rows. Replaces gg_pipeline.py:159
// make_group_gemm_dw_kernel with ragged=True (its panel-guarded AᵀG with
// the tail rows of A zeroed), launched by triton_dist_tpu/ops/
// group_gemm.py:534 _group_gemm_dw_fused with the alignment's valid_rows.
//
// What bounds it: the live rows' products (operations, ~1.6x fewer than
// K11's at the Mixtral backward's routing) and the f32 output written once
// (bytes), which no skipping shrinks.
//
// What the design does about it: the CTA's list holds steps, not blocks:
// the 64-row (f32: 16-row) steps of its expert's blocks that start below
// the block's live count (gemm_core.cuh Groups::live_rows's convention),
// in block order, each with its live rows. A dead step is never loaded.
// In a step that straddles the live count the rows at or past it are
// zeroed in the landed shared-memory stage, in A and in G, before the
// mma, so junk in G's dead rows (a NaN) changes nothing. With a null map
// every step is listed whole and the kernel is K11: its sum order is the
// same steps in the same order, so an f32 acc + 0 for each skipped step is
// the only difference from K11 on zeroed dead rows, and that is exact.

#include "gemm_core.cuh"

namespace {

using namespace tdt;

template <class E, typename TB, typename TOut, bool ACT>
__global__ void __launch_bounds__(E::THREADS, 1)
    group_gemm_kernel(const typename E::TIn* __restrict__ a, const TB* __restrict__ b,
                      const float* __restrict__ scale, TOut* __restrict__ c, int m, int n,
                      int k, int vec, Groups g) {
  const int m0 = blockIdx.y * E::BM, n0 = blockIdx.x * E::BN;
  const int live = g.live_rows(m0);
  if (live <= 0) {  // K29: a dead tile reads the map once, no A and no B
    store_zero_tile<E::BM, E::BN, E::THREADS>(c, m, n, m0, n0);
    return;
  }
  const AddList<TOut> none = {};
  typename E::Acc acc;
  E::template mainloop<ACT>(a, b + g.b_offset(m0, k, n), m, n, k, m0, n0, vec, acc);
  E::template store<false>(acc, c, m, n, m0, n0, none, g.scale_row(scale, m0, n),
                           m0 + live);
}

template <class E, typename TB, typename TOut, bool ACT>
cudaError_t launch(const void* a, const void* b, const float* scale, void* c, int m, int n,
                   int k, int vec, const Groups& g, cudaStream_t s) {
  if (E::SMEM_BYTES > 0) {
    cudaError_t attr = cudaFuncSetAttribute(group_gemm_kernel<E, TB, TOut, ACT>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            E::SMEM_BYTES);
    if (attr != cudaSuccess) return attr;
  }
  const dim3 grid(cdiv(n, E::BN), m / E::BM);
  group_gemm_kernel<E, TB, TOut, ACT><<<grid, E::THREADS, E::SMEM_BYTES, s>>>(
      static_cast<const typename E::TIn*>(a), static_cast<const TB*>(b), scale,
      static_cast<TOut*>(c), m, n, k, vec, g);
  return cudaSuccess;
}

// ------------------------------------------------------------------ K11 ----
constexpr int DW_LIST = 1024;  // steps listed per pass

// The live steps of expert e among blocks [base, base + blocks) (blocks *
// spb <= DW_LIST; spb steps of br rows a block of bm rows), in block order,
// into list (the step's index: its rows start at list[s] * br) and live
// (its live rows, 1..br: all of them without a map, else the block's
// valid_rows count less the step's offset); returns how many. Every thread
// of the block takes part and gets the same count.
__device__ int list_steps(const int* __restrict__ ids, const int* __restrict__ valid, int base,
                          int blocks, int spb, int br, int bm, int e, int n_exp, int* list,
                          int* live, int* warp_counts) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const int count = blocks * spb;
  int total = 0;
  for (int c0 = 0; c0 < count; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    bool hit = false;
    int rows = 0;
    if (c < count) {
      const int i = base + c / spb;
      int id = ids[i];
      id = id < 0 ? 0 : (id >= n_exp ? n_exp - 1 : id);
      rows = br;
      if (valid != nullptr) {
        int v = valid[i];
        v = v < 0 ? 0 : (v > bm ? bm : v);
        rows = v - (c % spb) * br;
        rows = rows < 0 ? 0 : (rows > br ? br : rows);
      }
      hit = id == e && rows > 0;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_counts[warp] = __popc(mask);
    __syncthreads();
    int before = total, sum = 0;
    for (int w = 0; w < warps; ++w) {
      if (w < warp) before += warp_counts[w];
      sum += warp_counts[w];
    }
    if (hit) {
      const int at = before + __popc(mask & ((1u << lane) - 1u));
      list[at] = base * spb + c;
      live[at] = rows;
    }
    __syncthreads();  // warp_counts is rewritten by the next round
    total += sum;
  }
  return total;
}

// bf16: K1's tile engine with the roles turned: the output tile is
// [BM of k] x [BN of n], the reduction runs over the listed rows, BR a step.
struct DwBf16 {
  typedef bf16 TIn;
  typedef Bf16Engine::Acc Acc;  // same warp tiling: Bf16Engine::store writes it
  static constexpr int BM = 128, BN = 256, BR = 64, THREADS = 256, STAGES = 3;
  static constexpr int A_LD = BM + 8;  // 272-byte rows: the 8 rows an
  static constexpr int B_LD = BN + 8;  // ldmatrix reads in 8 bank groups
  static constexpr int WM = 64, WN = 64, MT = WM / 16, NT = WN / 8;
  static constexpr int A_STAGE = BR * A_LD, B_STAGE = BR * B_LD;  // elements
  static constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;

  __device__ static __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc.v[i][j][e] = 0.f;
  }

  // rows [from, BR) of a landed [BR][ld] stage, columns [0, cols), to zero
  __device__ static __forceinline__ void zero_rows(bf16* st, int ld, int cols, int from) {
    for (int e = threadIdx.x; e < (BR - from) * (cols / 8); e += THREADS) {
      const int r = from + e / (cols / 8), c = (e % (cols / 8)) * 8;
      *reinterpret_cast<uint4*>(st + r * ld + c) = make_uint4(0, 0, 0, 0);
    }
  }

  // rows [r0, r0 + BR): A[:, k0:k0+BM] as [BR][BM] and G[:, n0:n0+BN] as
  // [BR][BN], both as stored (row-major, rows outermost)
  __device__ static __forceinline__ void load_step(bf16* as, bf16* bs,
                                                   const bf16* __restrict__ a,
                                                   const bf16* __restrict__ g, int m, int k,
                                                   int n, int r0, int k0, int n0, int vec) {
#pragma unroll
    for (int i = 0; i < BR * BM / 8 / THREADS; ++i) {
      const int chunk = threadIdx.x + i * THREADS;
      const int r = chunk / (BM / 8), c = (chunk % (BM / 8)) * 8;
      Bf16Engine::load_chunk(as + r * A_LD + c, a, r0 + r, k0 + c, m, k, vec);
    }
#pragma unroll
    for (int i = 0; i < BR * BN / 8 / THREADS; ++i) {
      const int chunk = threadIdx.x + i * THREADS;
      const int r = chunk / (BN / 8), c = (chunk % (BN / 8)) * 8;
      Bf16Engine::load_chunk(bs + r * B_LD + c, g, r0 + r, n0 + c, m, n, vec);
    }
  }

  // acc += A[rows]^T . G[rows] over the listed steps (step s: rows
  // list[s] * BR, BR of them, the rows at or past live[s] zeroed once they
  // have landed). The dynamic shared memory is declared here, inside the
  // loop's function.
  __device__ static __forceinline__ void mainloop(const bf16* __restrict__ a,
                                                  const bf16* __restrict__ g, int m, int k,
                                                  int n, int k0, int n0, int vec,
                                                  const int* list, const int* live, int steps,
                                                  Acc& acc) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* as = reinterpret_cast<bf16*>(smem);  // [STAGES][BR][A_LD]
    bf16* bs = as + STAGES * A_STAGE;          // [STAGES][BR][B_LD]
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / (BN / WN), wn = warp % (BN / WN);
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < steps)
        load_step(as + st * A_STAGE, bs + st * B_STAGE, a, g, m, k, n, list[st] * BR, k0,
                  n0, vec);
      cp_async_commit();
    }
    for (int kt = 0; kt < steps; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (live[kt] < BR) {  // K34: the step straddles its block's live count
        zero_rows(as + (kt % STAGES) * A_STAGE, A_LD, BM, live[kt]);
        zero_rows(bs + (kt % STAGES) * B_STAGE, B_LD, BN, live[kt]);
        __syncthreads();
      }
      const int pre = kt + STAGES - 1;
      if (pre < steps) {
        const int ps = pre % STAGES;
        load_step(as + ps * A_STAGE, bs + ps * B_STAGE, a, g, m, k, n, list[pre] * BR, k0,
                  n0, vec);
      }
      cp_async_commit();
      const bf16* at = as + (kt % STAGES) * A_STAGE;
      const bf16* bt = bs + (kt % STAGES) * B_STAGE;
#pragma unroll
      for (int kk = 0; kk < BR; kk += 16) {
        unsigned af[MT][4], bfr[NT][2];
        // A^T fragments from the [rows][k] tile: lanes 0-7 / 8-15 address
        // rows kk..kk+7 at k columns +0 / +8, lanes 16-31 rows kk+8..kk+15;
        // the transposing load hands each thread the row-major m16k16
        // pieces a0..a3
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldmatrix_x4_trans(af[i], at + (kk + lane % 8 + (lane / 16) * 8) * A_LD + wm * WM +
                                       i * 16 + ((lane / 8) % 2) * 8);
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
          for (int j = 0; j < NT; ++j) mma_bf16(acc.v[i][j], af[i], bfr[j]);
      }
    }
    cp_async_wait<0>();
  }

  __device__ static __forceinline__ void store(const Acc& acc, float* c, int k, int n, int k0,
                                               int n0) {
    const AddList<float> none = {};
    Bf16Engine::store<false>(acc, c, k, n, k0, n0, none);
  }
};

// f32: F32Engine's FMA tile; its shared tiles are [rows][cols] already
struct DwF32 {
  typedef float TIn;
  typedef F32Engine::Acc Acc;
  static constexpr int BM = 64, BN = 64, BR = 16, THREADS = 256;
  static constexpr int SMEM_BYTES = 0;

  __device__ static __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc.v[i][j] = 0.f;
  }

  __device__ static __forceinline__ void mainloop(const float* __restrict__ a,
                                                  const float* __restrict__ g, int, int k,
                                                  int n, int k0, int n0, int,
                                                  const int* list, const int* live, int steps,
                                                  Acc& acc) {
    __shared__ float as[BR][BM + 4];
    __shared__ float bs[BR][BN + 4];
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    for (int s = 0; s < steps; ++s) {
      const size_t r0 = (size_t)list[s] * BR;
      const int lv = live[s];  // K34: rows at or past it are zeros
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = tid + i * THREADS;
        const int ra = e / BM, ca = e % BM;
        as[ra][ca] = ra < lv && k0 + ca < k ? a[(r0 + ra) * k + k0 + ca] : 0.f;
        const int rb = e / BN, cb = e % BN;
        bs[rb][cb] = rb < lv && n0 + cb < n ? g[(r0 + rb) * n + n0 + cb] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BR; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = as[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc.v[i][j] = fmaf(av[i], bv[j], acc.v[i][j]);
      }
      __syncthreads();
    }
  }

  __device__ static __forceinline__ void store(const Acc& acc, float* c, int k, int n, int k0,
                                               int n0) {
    const AddList<float> none = {};
    F32Engine::store<false>(acc, c, k, n, k0, n0, none);
  }
};

template <class D>
__global__ void __launch_bounds__(D::THREADS, 1)
    group_gemm_dw_kernel(const typename D::TIn* __restrict__ a,
                         const typename D::TIn* __restrict__ g, const int* __restrict__ ids,
                         const int* __restrict__ valid, float* __restrict__ dw, int m, int k,
                         int n, int n_exp, int bm, int vec) {
  __shared__ int list[DW_LIST];
  __shared__ int live[DW_LIST];
  __shared__ int warp_counts[D::THREADS / 32];
  const int e = blockIdx.z, k0 = blockIdx.y * D::BM, n0 = blockIdx.x * D::BN;
  const int nb = m / bm, spb = bm / D::BR, per_pass = DW_LIST / spb;
  typename D::Acc acc;
  D::zero(acc);
  for (int base = 0; base < nb; base += per_pass) {
    const int cnt = list_steps(ids, valid, base, nb - base < per_pass ? nb - base : per_pass,
                               spb, D::BR, bm, e, n_exp, list, live, warp_counts);
    if (cnt > 0) D::mainloop(a, g, m, k, n, k0, n0, vec, list, live, cnt, acc);
    __syncthreads();  // every thread is done with the lists and the stages
  }
  D::store(acc, dw + (size_t)e * k * n, k, n, k0, n0);
}

template <class D>
cudaError_t launch_dw(const void* a, const void* g, const int* ids, const int* valid, float* dw,
                      int m, int k, int n, int n_exp, int bm, int vec, cudaStream_t s) {
  if (D::SMEM_BYTES > 0) {
    cudaError_t attr = cudaFuncSetAttribute(group_gemm_dw_kernel<D>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            D::SMEM_BYTES);
    if (attr != cudaSuccess) return attr;
  }
  const dim3 grid(cdiv(n, D::BN), cdiv(k, D::BM), n_exp);
  group_gemm_dw_kernel<D><<<grid, D::THREADS, D::SMEM_BYTES, s>>>(
      static_cast<const typename D::TIn*>(a), static_cast<const typename D::TIn*>(g), ids,
      valid, dw, m, k, n, n_exp, bm, vec);
  return cudaSuccess;
}

}  // namespace

// K11: a [m, k], g [m, n] in one type, expert_ids int32 [m / block_m], dw
// [n_exp, k, n] f32; block_m a multiple of 64 that divides m. valid_rows:
// null (K11), or int32 [m / block_m], each block's live rows (K34).
extern "C" int tdt_group_gemm_dw(const void* a, const void* g, const void* expert_ids,
                                 const void* valid_rows, void* dw, int m, int k, int n,
                                 int n_exp, int block_m, int dtype, void* stream) {
  if (block_m <= 0 || block_m % DwBf16::BR != 0 || block_m / DwF32::BR > DW_LIST ||
      m % block_m != 0 || n_exp < 1 ||
      n_exp > 65535 || k < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(expert_ids);
  const int* valid = static_cast<const int*>(valid_rows);
  float* out = static_cast<float*>(dw);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kBF16)
    err = launch_dw<DwBf16>(a, g, ids, valid, out, m, k, n, n_exp, block_m,
                            bf16_vec_ok(a, g, n, k), s);
  else if (dtype == kF32)
    err = launch_dw<DwF32>(a, g, ids, valid, out, m, k, n, n_exp, block_m, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// a [m, k], b [n_exp, k, n], expert_ids int32 [m / block_m], c [m, n];
// block_m a multiple of 128 that divides m; act 1 = tanh GELU on A. b is in
// A's type (b_dtype == in_dtype, scale null: K8) or int8 / fp8 e4m3 with
// its f32 scale bank [n_exp, 1, n] (K24; n a multiple of 16, b 16-byte
// aligned). valid_rows: null (padded), or int32 [m / block_m], each block's
// live rows (K29, any of the formats).
extern "C" int tdt_group_gemm(const void* a, const void* b, const void* scale,
                              const void* expert_ids, const void* valid_rows, void* c, int m,
                              int n, int k, int n_exp, int block_m, int in_dtype, int b_dtype,
                              int out_dtype, int act, void* stream) {
  const bool scaled = b_dtype == kI8 || b_dtype == kFP8;
  if (block_m <= 0 || block_m % 128 != 0 || m % block_m != 0 || n_exp < 1 ||
      scaled != (scale != nullptr) || (scaled && !byte_b_ok(b, n)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Groups g = {static_cast<const int*>(expert_ids), block_m, n_exp,
                    static_cast<const int*>(valid_rows)};
  const float* sc = static_cast<const float*>(scale);
  cudaError_t err = dispatch_dtypes(in_dtype, out_dtype, [&](auto e, auto t) {
    using E = decltype(e);
    using TOut = decltype(t);
    return dispatch_weights<typename E::TIn>(in_dtype, b_dtype, [&](auto w) {
      using TB = decltype(w);
      int vec = 0;
      if (in_dtype == kBF16)
        vec = scaled ? (k % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0)
                     : bf16_vec_ok(a, b, n, k);
      return act ? launch<E, TB, TOut, true>(a, b, sc, c, m, n, k, vec, g, s)
                 : launch<E, TB, TOut, false>(a, b, sc, c, m, n, k, vec, g, s);
    });
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
