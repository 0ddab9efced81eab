// The GEMM tile engines shared by K1 (csrc/gemm.cu) and the fused
// communication GEMMs K6/K7 (csrc/dist.cu): one output tile
// C[m0:m0+BM, n0:n0+BN] = A[m0:, :] . B[:, n0:] with an f32 accumulator,
// and its store with the optional epilogue adds of gemm_add_pipeline
// (triton_dist_tpu/ops/common.py:468): O = A.B + sum(adds), summed in f32
// in the order given, then cast once.
//
// Bf16Engine: m16n8k16 mma.sync with ldmatrix fragment loads on a 128x256
// block tile, 64-deep k step, a three-stage cp.async ring; 8 warps each own
// a 64x64 sub-tile. F32Engine: a shared-memory-tiled FMA tile in full f32
// (no TF32), the reference precision. Ragged edges are zero-filled on load
// and masked on store. The source note in csrc/gemm.cu says what bounds
// them and why.
//
// mainloop<true> applies the tanh GELU to every A element once it is in
// shared memory, in f32, rounded back to A's type: the fused producer
// activation of the grouped GEMM (csrc/group_gemm.cu). Groups selects the
// B operand of an M tile by its row block's expert (the grouped GEMMs).
//
// The ragged-row policy (K29-K31; triton_dist_tpu/ops/gg_pipeline.py:110-152):
// Groups may carry the per-block live-row map `valid`. A tile whose first
// row lies at or past its block's live count is dead: the kernel stores it
// as zeros (store_zero_tile) and reads no B. A live tile runs the unchanged
// mainloop, and `store` writes rows at or past `live_end` as zeros, after
// the scale fold, so its live rows are the padded kernel's bit for bit.
//
// The scaled weight formats (K24-K26; triton_dist_tpu/ops/gg_pipeline.py:43
// OperandFormat): B may be int8 or fp8 e4m3 (TB of one byte) under A of
// either type. B is upcast to A's type before the product (OperandFormat.
// mxu_b; exact: |q| <= 127 and every e4m3 value fit bf16), and `store`
// multiplies the f32 accumulator by the expert's scale row once, before
// the cast (OperandFormat.fold). Bf16Engine stages the one-byte B tile raw
// through 16-byte cp.async (16 weights a copy, a quarter of the bf16 B
// stage's shared memory), and converts the landed stage into one bf16 tile
// behind the k step's __syncthreads, from which the unchanged ldmatrix.trans
// fragment loads read; F32Engine converts each weight as it loads it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdt {

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };
typedef __nv_bfloat16 bf16;
typedef __nv_fp8_e4m3 fp8;

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
// a weight of any B format as f32, exactly
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}
template <> __device__ __forceinline__ float to_f32<fp8>(fp8 x) { return static_cast<float>(x); }
// two one-byte weights packed low byte first, as f32
template <typename TB> __device__ __forceinline__ float2 pair_to_f32(unsigned short two);
template <> __device__ __forceinline__ float2 pair_to_f32<int8_t>(unsigned short two) {
  return make_float2(static_cast<float>(static_cast<signed char>(two & 0xff)),
                     static_cast<float>(static_cast<signed char>(two >> 8)));
}
template <> __device__ __forceinline__ float2 pair_to_f32<fp8>(unsigned short two) {
  return __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(two, __NV_E4M3)));
}

// Epilogue adds: up to world - 1 = 7 row-major [m, n] matrices in the
// output type, passed by value as a kernel parameter.
constexpr int MAX_ADDS = 7;
template <typename T> struct AddList {
  const T* p[MAX_ADDS];
  int n;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// `store`'s live_end when every row of the tile is live
constexpr int ALL_ROWS = 0x7fffffff;

// A dead tile of the ragged policy: C[m0:m0+BM, n0:n0+BN] (inside [m, n])
// written as zeros, neighbouring threads on neighbouring columns.
template <int BM, int BN, int THREADS, typename TOut>
__device__ __forceinline__ void store_zero_tile(TOut* __restrict__ c, int m, int n, int m0,
                                                int n0) {
  const TOut zero = from_f32<TOut>(0.f);
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int rr = m0 + i / BN, cc = n0 + i % BN;
    if (rr < m && cc < n) c[(size_t)rr * n + cc] = zero;
  }
}

// The tanh form of GELU (jax.nn.gelu's default, torch's approximate="tanh"),
// in torch's operation order.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k_beta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k_kappa = 0.044715f;
  const float inner = k_beta * (x + k_kappa * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
}

// Expert banks of a grouped GEMM: B is [n_exp, k, n]; rows [i*block_m,
// (i+1)*block_m) of A multiply B[ids[i]] (ids clamped into the bank, as
// the JAX package's golden clamps them). block_m is a multiple of every
// engine's BM, so an M tile never straddles two experts.
// The scale row of a tile's expert is the clamped expert's too, as the
// golden clamps it (triton_dist_tpu/ops/group_gemm.py:231).
struct Groups {
  const int* ids;
  int block_m;
  int n_exp;
  const int* valid;  // [blocks] live rows of each block, or null: all live

  // rows of the tile at m0 that lie before its block's live count (<= 0:
  // the tile is dead); the rest of the block without a map
  __device__ __forceinline__ int live_rows(int m0) const {
    return (valid ? valid[m0 / block_m] : block_m) - m0 % block_m;
  }

  __device__ __forceinline__ int expert(int m0) const {
    const int e = ids[m0 / block_m];
    return e < 0 ? 0 : (e >= n_exp ? n_exp - 1 : e);
  }
  __device__ __forceinline__ size_t b_offset(int m0, int k, int n) const {
    return (size_t)expert(m0) * k * n;
  }
  // the expert's [n] scale row in an [n_exp, 1, n] bank, or none
  __device__ __forceinline__ const float* scale_row(const float* scale, int m0, int n) const {
    return scale ? scale + (size_t)expert(m0) * n : nullptr;
  }
};

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

// One stored element: the accumulator times the column's scale (the scaled
// formats' fold, `scale` non-null), plus (with ADDS) the epilogue adds, in
// f32. Without ADDS the store is the plain cast, no add code at all.
template <bool ADDS, typename TOut>
__device__ __forceinline__ void store_elem(TOut* c, int n, int rr, int cc, float v,
                                           const AddList<TOut>& adds, const float* scale) {
  const size_t at = (size_t)rr * n + cc;
  if (scale) v *= scale[cc];
  if (ADDS) {
    // constant indices keep the pointer array in the parameter bank
#pragma unroll
    for (int t = 0; t < MAX_ADDS; ++t)
      if (t < adds.n) v += to_f32<TOut>(adds.p[t][at]);
  }
  c[at] = from_f32<TOut>(v);
}

// ---------------------------------------------------------------- bf16 ----
struct Bf16Engine {
  typedef bf16 TIn;
  static constexpr int BM = 128, BN = 256, BK = 64, THREADS = 256, STAGES = 3;
  static constexpr int A_LD = BK + 8;  // padded smem rows (bf16 elements): 144-
  static constexpr int B_LD = BN + 8;  // and 528-byte rows put the 8 rows an
                                       // ldmatrix reads in 8 bank groups
  static constexpr int WM = 64, WN = 64;           // warp tile; 2 x 4 warps
  static constexpr int MT = WM / 16, NT = WN / 8;  // m16n8k16 tiles per warp
  static constexpr int A_STAGE = BM * A_LD, B_STAGE = BK * B_LD;  // elements
  static constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;
  // one-byte B: STAGES raw [BK][BN] byte stages after the A stages, then
  // one bf16 [BK][B_LD] tile converted from the stage in use
  static constexpr int BRAW_STAGE = BK * BN;  // bytes
  static_assert(STAGES * A_STAGE * 2 + STAGES * BRAW_STAGE + B_STAGE * 2 <= SMEM_BYTES,
                "the one-byte B layout fits the bf16 footprint");

  struct Acc {
    float v[MT][NT][4];
  };

  // One 8-element chunk of a row-major [rows, cols] matrix into shared
  // memory. `vec` (cols a multiple of 8, 16-byte aligned base) lets a whole
  // chunk ride cp.async; a chunk past the edge is zero-filled. Without `vec`
  // every element is loaded with its own bounds check.
  __device__ static __forceinline__ void load_chunk(bf16* dst, const bf16* __restrict__ src,
                                                    int r, int c, int rows, int cols,
                                                    int vec) {
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
  // A one-byte B goes raw into `bs` ([BK][BN] bytes): 1024 chunks of 16,
  // four per thread, always by cp.async (the caller guarantees n % 16 == 0
  // and a 16-byte aligned bank, so a chunk is wholly inside or outside).
  template <typename TB>
  __device__ static __forceinline__ void load_tile(bf16* as, void* bs,
                                                   const bf16* __restrict__ a,
                                                   const TB* __restrict__ b, int m,
                                                   int n, int k, int m0, int n0, int k0,
                                                   int vec) {
#pragma unroll
    for (int i = 0; i < BM * BK / 8 / THREADS; ++i) {
      const int chunk = threadIdx.x + i * THREADS;
      const int r = chunk / (BK / 8), c = (chunk % (BK / 8)) * 8;
      load_chunk(as + r * A_LD + c, a, m0 + r, k0 + c, m, k, vec);
    }
    if constexpr (sizeof(TB) == 1) {
      unsigned char* raw = static_cast<unsigned char*>(bs);
#pragma unroll
      for (int i = 0; i < BK * BN / 16 / THREADS; ++i) {
        const int chunk = threadIdx.x + i * THREADS;
        const int r = chunk / (BN / 16), c = (chunk % (BN / 16)) * 16;
        if (k0 + r < k && n0 + c < n) {
          cp_async16(raw + r * BN + c, b + (size_t)(k0 + r) * n + n0 + c);
        } else {
          *reinterpret_cast<uint4*>(raw + r * BN + c) = make_uint4(0, 0, 0, 0);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK * BN / 8 / THREADS; ++i) {
        const int chunk = threadIdx.x + i * THREADS;
        const int r = chunk / (BN / 8), c = (chunk % (BN / 8)) * 8;
        load_chunk(static_cast<bf16*>(bs) + r * B_LD + c, b, k0 + r, n0 + c, k, n, vec);
      }
    }
  }

  // The landed raw stage of a one-byte B as bf16 into the [BK][B_LD] tile:
  // 16 weights a thread and step (one 16-byte shared load, two stores).
  template <typename TB>
  __device__ static __forceinline__ void convert_b(const unsigned char* raw, bf16* bt) {
#pragma unroll
    for (int i = 0; i < BK * BN / 16 / THREADS; ++i) {
      const int chunk = threadIdx.x + i * THREADS;
      const int r = chunk / (BN / 16), c = (chunk % (BN / 16)) * 16;
      const uint4 q = *reinterpret_cast<const uint4*>(raw + r * BN + c);
      const unsigned words[4] = {q.x, q.y, q.z, q.w};
      __nv_bfloat162 h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[e] = __float22bfloat162_rn(
            pair_to_f32<TB>(static_cast<unsigned short>(words[e / 2] >> (16 * (e % 2)))));
      uint4* dst = reinterpret_cast<uint4*>(bt + r * B_LD + c);
      dst[0] = *reinterpret_cast<const uint4*>(&h[0]);
      dst[1] = *reinterpret_cast<const uint4*>(&h[4]);
    }
  }

  // The whole k loop of one output tile, in the block's dynamic shared
  // memory (declared here, so the compiler sees the shared address space).
  // A block that runs several tiles (the persistent consumers) calls
  // __syncthreads() between them: the prologue below overwrites stages the
  // previous tile's last step read.
  template <bool ACT = false, typename TB = bf16>
  __device__ static __forceinline__ void mainloop(const bf16* __restrict__ a,
                                                  const TB* __restrict__ b, int m, int n,
                                                  int k, int m0, int n0, int vec, Acc& acc) {
    constexpr bool BYTE_B = sizeof(TB) == 1;
    static_assert(BYTE_B || sizeof(TB) == 2, "B is bf16 or a one-byte format");
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* as = reinterpret_cast<bf16*>(smem);  // [STAGES][BM][A_LD]
    bf16* bs = as + STAGES * A_STAGE;          // [STAGES][BK][B_LD] (bf16 B)
    // one-byte B: [STAGES][BK][BN] raw bytes at bs, the converted tile after
    unsigned char* braw = reinterpret_cast<unsigned char*>(bs);
    bf16* bcv = reinterpret_cast<bf16*>(braw + STAGES * BRAW_STAGE);
    auto stage_b = [&](int st) -> void* {
      return BYTE_B ? static_cast<void*>(braw + st * BRAW_STAGE)
                    : static_cast<void*>(bs + st * B_STAGE);
    };
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / (BN / WN), wn = warp % (BN / WN);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc.v[i][j][e] = 0.f;

    const int nk = (k + BK - 1) / BK;
    // prologue: STAGES-1 tiles in flight (a group is committed even when
    // empty, so the wait counts below stay uniform)
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nk) load_tile(as + st * A_STAGE, stage_b(st), a, b, m, n, k, m0, n0, st * BK, vec);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();
      // tile kt has landed for every thread, and every warp has finished
      // reading the stage the next prefetch overwrites (tile kt - 1's) and
      // the converted B tile
      __syncthreads();
      if constexpr (BYTE_B) convert_b<TB>(braw + (kt % STAGES) * BRAW_STAGE, bcv);
      if constexpr (ACT) {
        bf16* at_w = as + (kt % STAGES) * A_STAGE;
        for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
          bf16* p = at_w + (i / BK) * A_LD + i % BK;
          *p = __float2bfloat16(gelu_tanh(__bfloat162float(*p)));
        }
      }
      if constexpr (ACT || BYTE_B) __syncthreads();
      const int pre = kt + STAGES - 1;
      if (pre < nk) {
        const int ps = pre % STAGES;
        load_tile(as + ps * A_STAGE, stage_b(ps), a, b, m, n, k, m0, n0, pre * BK, vec);
      }
      cp_async_commit();
      const bf16* at = as + (kt % STAGES) * A_STAGE;
      const bf16* bt = BYTE_B ? bcv : bs + (kt % STAGES) * B_STAGE;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        unsigned af[MT][4], bfr[NT][2];
        // A: lanes 0-15 address rows 0-15 at k kk, lanes 16-31 the same
        // rows at kk + 8 -> the four 8x8 pieces of a row-major m16k16
        // fragment
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
          for (int j = 0; j < NT; ++j) mma_bf16(acc.v[i][j], af[i], bfr[j]);
      }
    }
    cp_async_wait<0>();
  }

  // epilogue: thread holds rows lane/4 and lane/4 + 8, columns 2*(lane%4)
  // and +1, of each m16n8 tile; the ragged edge is masked, rows at or past
  // live_end are written as zeros
  template <bool ADDS, typename TOut>
  __device__ static __forceinline__ void store(const Acc& acc, TOut* __restrict__ c, int m,
                                               int n, int m0, int n0,
                                               const AddList<TOut>& adds,
                                               const float* scale = nullptr,
                                               int live_end = ALL_ROWS) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / (BN / WN), wn = warp % (BN / WN);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = m0 + wm * WM + i * 16 + lane / 4;
        const int col = n0 + wn * WN + j * 8 + (lane % 4) * 2;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = r + (e / 2) * 8, cc = col + e % 2;
          if (rr < m && cc < n) {
            if (rr < live_end) store_elem<ADDS>(c, n, rr, cc, acc.v[i][j][e], adds, scale);
            else c[(size_t)rr * n + cc] = from_f32<TOut>(0.f);
          }
        }
      }
    }
  }
};

// ----------------------------------------------------------------- f32 ----
struct F32Engine {
  typedef float TIn;
  static constexpr int BM = 64, BN = 64, FK = 16, THREADS = 256;  // 4x4 per thread
  static constexpr int SMEM_BYTES = 0;  // static shared memory only

  struct Acc {
    float v[4][4];
  };

  template <bool ACT = false, typename TB = float>
  __device__ static __forceinline__ void mainloop(const float* __restrict__ a,
                                                  const TB* __restrict__ b, int m, int n,
                                                  int k, int m0, int n0, int, Acc& acc) {
    __shared__ float as[FK][BM + 4];  // transposed: as[kk][row]
    __shared__ float bs[FK][BN + 4];
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc.v[i][j] = 0.f;
    for (int k0 = 0; k0 < k; k0 += FK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = tid + i * 256;
        const int ra = e / FK, ka = e % FK;
        const float av = (m0 + ra < m && k0 + ka < k) ? a[(size_t)(m0 + ra) * k + k0 + ka] : 0.f;
        as[ka][ra] = ACT ? gelu_tanh(av) : av;
        const int kb = e / BN, cb = e % BN;
        bs[kb][cb] =
            (k0 + kb < k && n0 + cb < n) ? to_f32<TB>(b[(size_t)(k0 + kb) * n + n0 + cb]) : 0.f;
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
          for (int j = 0; j < 4; ++j) acc.v[i][j] = fmaf(av[i], bv[j], acc.v[i][j]);
      }
      __syncthreads();
    }
  }

  template <bool ADDS, typename TOut>
  __device__ static __forceinline__ void store(const Acc& acc, TOut* __restrict__ c, int m,
                                               int n, int m0, int n0,
                                               const AddList<TOut>& adds,
                                               const float* scale = nullptr,
                                               int live_end = ALL_ROWS) {
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        if (r < m && col < n) {
          if (r < live_end) store_elem<ADDS>(c, n, r, col, acc.v[i][j], adds, scale);
          else c[(size_t)r * n + col] = from_f32<TOut>(0.f);
        }
      }
    }
  }
};

// cp.async's 16-byte path needs K and N multiples of 8 and aligned bases
inline int bf16_vec_ok(const void* a, const void* b, int n, int k) {
  return (k % 8 == 0) && (n % 8 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
         (reinterpret_cast<uintptr_t>(b) % 16 == 0);
}

// A one-byte bank rides 16-byte cp.async: its rows must be 16-byte multiples
// on a 16-byte aligned base (the wrappers refuse other widths)
inline int byte_b_ok(const void* b, int n) {
  return (n % 16 == 0) && (reinterpret_cast<uintptr_t>(b) % 16 == 0);
}

// Call f(TB{}) for the weight dtype code under activations of type TIn: the
// activation's own type, or a one-byte scaled format; cudaErrorInvalidValue
// for anything else.
template <typename TIn, typename F>
cudaError_t dispatch_weights(int in_dtype, int b_dtype, F&& f) {
  if (b_dtype == in_dtype) return f(TIn{});
  if (b_dtype == kI8) return f(int8_t{});
  if (b_dtype == kFP8) return f(fp8{});
  return cudaErrorInvalidValue;
}

// Call f(Engine{}, TOut{}) for the (input, output) dtype codes; returns
// cudaErrorInvalidValue for a pair the kernels do not take.
template <typename F>
cudaError_t dispatch_dtypes(int in_dtype, int out_dtype, F&& f) {
  if (in_dtype == kBF16) {
    if (out_dtype == kBF16) return f(Bf16Engine{}, bf16{});
    if (out_dtype == kF32) return f(Bf16Engine{}, float{});
  } else if (in_dtype == kF32) {
    if (out_dtype == kF32) return f(F32Engine{}, float{});
    if (out_dtype == kBF16) return f(F32Engine{}, bf16{});
  }
  return cudaErrorInvalidValue;
}

template <typename TOut>
AddList<TOut> make_adds(const void* const* ptrs, int n) {
  AddList<TOut> adds;
  adds.n = n;
  for (int i = 0; i < MAX_ADDS; ++i)
    adds.p[i] = i < n ? static_cast<const TOut*>(ptrs[i]) : nullptr;
  return adds;
}

}  // namespace tdt
