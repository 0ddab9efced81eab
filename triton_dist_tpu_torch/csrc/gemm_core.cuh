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

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdt {

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

// Epilogue adds: up to world - 1 = 7 row-major [m, n] matrices in the
// output type, passed by value as a kernel parameter.
constexpr int MAX_ADDS = 7;
template <typename T> struct AddList {
  const T* p[MAX_ADDS];
  int n;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

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
struct Groups {
  const int* ids;
  int block_m;
  int n_exp;

  __device__ __forceinline__ size_t b_offset(int m0, int k, int n) const {
    int e = ids[m0 / block_m];
    e = e < 0 ? 0 : (e >= n_exp ? n_exp - 1 : e);
    return (size_t)e * k * n;
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

// One stored element: the accumulator plus (with ADDS) the epilogue adds,
// in f32. Without ADDS the store is the plain cast, no add code at all.
template <bool ADDS, typename TOut>
__device__ __forceinline__ void store_elem(TOut* c, int n, int rr, int cc, float v,
                                           const AddList<TOut>& adds) {
  const size_t at = (size_t)rr * n + cc;
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
  __device__ static __forceinline__ void load_tile(bf16* as, bf16* bs,
                                                   const bf16* __restrict__ a,
                                                   const bf16* __restrict__ b, int m,
                                                   int n, int k, int m0, int n0, int k0,
                                                   int vec) {
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

  // The whole k loop of one output tile, in the block's dynamic shared
  // memory (declared here, so the compiler sees the shared address space).
  // A block that runs several tiles (the persistent consumers) calls
  // __syncthreads() between them: the prologue below overwrites stages the
  // previous tile's last step read.
  template <bool ACT = false>
  __device__ static __forceinline__ void mainloop(const bf16* __restrict__ a,
                                                  const bf16* __restrict__ b, int m, int n,
                                                  int k, int m0, int n0, int vec, Acc& acc) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* as = reinterpret_cast<bf16*>(smem);  // [STAGES][BM][A_LD]
    bf16* bs = as + STAGES * A_STAGE;          // [STAGES][BK][B_LD]
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
      if (st < nk)
        load_tile(as + st * A_STAGE, bs + st * B_STAGE, a, b, m, n, k, m0, n0, st * BK, vec);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();
      // tile kt has landed for every thread, and every warp has finished
      // reading the stage the next prefetch overwrites (tile kt - 1's)
      __syncthreads();
      if constexpr (ACT) {
        bf16* at_w = as + (kt % STAGES) * A_STAGE;
        for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
          bf16* p = at_w + (i / BK) * A_LD + i % BK;
          *p = __float2bfloat16(gelu_tanh(__bfloat162float(*p)));
        }
        __syncthreads();
      }
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
  // and +1, of each m16n8 tile; the ragged edge is masked
  template <bool ADDS, typename TOut>
  __device__ static __forceinline__ void store(const Acc& acc, TOut* __restrict__ c, int m,
                                               int n, int m0, int n0,
                                               const AddList<TOut>& adds) {
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
          if (rr < m && cc < n) store_elem<ADDS>(c, n, rr, cc, acc.v[i][j][e], adds);
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

  template <bool ACT = false>
  __device__ static __forceinline__ void mainloop(const float* __restrict__ a,
                                                  const float* __restrict__ b, int m, int n,
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
          for (int j = 0; j < 4; ++j) acc.v[i][j] = fmaf(av[i], bv[j], acc.v[i][j]);
      }
      __syncthreads();
    }
  }

  template <bool ADDS, typename TOut>
  __device__ static __forceinline__ void store(const Acc& acc, TOut* __restrict__ c, int m,
                                               int n, int m0, int n0,
                                               const AddList<TOut>& adds) {
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        if (r < m && col < n) store_elem<ADDS>(c, n, r, col, acc.v[i][j], adds);
      }
    }
  }
};

// cp.async's 16-byte path needs K and N multiples of 8 and aligned bases
inline int bf16_vec_ok(const void* a, const void* b, int n, int k) {
  return (k % 8 == 0) && (n % 8 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
         (reinterpret_cast<uintptr_t>(b) % 16 == 0);
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
