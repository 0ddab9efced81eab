// The ring kernels of the tensor-parallel path: each rank talks to its two
// neighbours only, as on a box whose ranks do not form a full mesh.
//
//   K15 tdt_ring_ag_gemm          ≙ ops/allgather_gemm.py:109
//                                   _ag_gemm_chunked_kernel (and, with one
//                                   span, the ring schedule of :69
//                                   _ag_gemm_kernel)
//   K16 tdt_ring_gemm_rs          ≙ ops/gemm_reduce_scatter.py:147
//       (one span)                  _gemm_rs_ring_kernel
//   K17 tdt_ring_gemm_rs          ≙ ops/gemm_reduce_scatter.py:187
//       (spans)                     _gemm_rs_ring_chunked_kernel
//   K18 tdt_ring_reduce_scatter   ≙ ops/reduce_scatter.py:102 _ring_rs_kernel
//
// What they compute. K15: out[c] = A_c @ B for every shard c, in the ring's
// arrival order c = me, me-1, ...; chunk j of shard c is forwarded to the
// right neighbour before its GEMM, and the gathered A is left in this
// rank's workspace. K16/K17: at step s the rank produces the partial of
// row chunk c = me-1-s (A_c @ B), adds the partial that landed from the
// left (step s > 0) in the f32 epilogue, rounds once to the output type and
// stores it straight into the right neighbour's landing slot s; after n-1
// hops its own chunk, fully reduced, is in `out`. K18 is K16 without the
// GEMM: step 0 sends chunk me-1 of x as it is, step s adds chunk me-1-s to
// the landed partial in f32 and rounds. The rounding per hop is the TPU
// kernels' (gemm_add_pipeline, ops/common.py:468, casts at every hop).
//
// What bounds them on the H100. K15-K17 are K1's tile loop (gemm_core.cuh)
// with waits in front of a chunk's tiles: tensor-core throughput at prefill
// shapes. K18 streams bytes: each rank reads its n chunks once, the landed
// partials once, and writes n-1 hops plus its own chunk.
//
// The design. A ring step waits on the left neighbour's previous step, so
// the waits sit inside the kernel that issues the puts: one persistent
// kernel per rank per call, of at most floor(SMs / ranks) - 2 blocks (the
// caller's cap), so every rank's blocks are resident together. Its work is
// one list of items in (step, chunk) order, dealt to the blocks
// round-robin: K15 a chunk's forward pieces then its GEMM tiles, K16/K17 a
// chunk's tiles, K18 a step's element pieces. An item of step s > 0 first
// waits (bounded, shmem.cuh wait_chunk) for the left neighbour's chunk of
// step s-1, which sits earlier in the left neighbour's list, so by
// induction over the steps every wait is met. Every store towards the
// right neighbour goes straight into its landing view through the peer
// table (K16/K17's epilogue, K15's and K18's pieces): no send buffer, no
// reuse wait. The block that finishes a chunk's last piece raises the
// neighbour's (step, chunk) flag (chunk_piece_done). Each slot of the
// landing buffers is written once per call; across calls the neighbour's
// arrival guards them: a kernel first tells its left neighbour it has
// started (so its reads of the previous call are over), and every block
// waits for the right neighbour's arrival before anything else.
//
// The host issues every allocation before a rendezvous of all ranks, then
// only the launch, then meets the ranks again (ops/common.py ring_launch and
// its callers): no device wait is issued before what it waits for, and no
// call that serialises streams runs while a peer's kernel is still to be
// launched.

#include "gemm_core.cuh"
#include "shmem.cuh"

namespace {

using namespace tdt;
using shmem::ChunkFlags;
using shmem::Spans;
using shmem::WaitCtx;

constexpr int MAX_WORLD = 8;
constexpr long long PIECE_BYTES = 256 * 1024;  // one forward piece of K15
constexpr long long PIECE_ELEMS = 64 * 1024;   // one element piece of K18

struct Ring {
  int world, me;
  const int* entry_wait;  // this rank's slot of its right neighbour's arrival
  int* entry_signal;      // the left neighbour's slot of this rank's arrival
  ChunkFlags f;
  WaitCtx w;

  __device__ __forceinline__ int right() const { return (me + 1) % world; }

  // a kernel's first act: tell the left neighbour this rank has started,
  // then wait (bounded) until the right neighbour has, before any store
  // into its buffers and before any other wait, so a neighbour that never
  // comes is what a timeout names
  __device__ __forceinline__ void enter() const {
    if (blockIdx.x == 0 && threadIdx.x == 0) shmem::signal_set(entry_signal, f.epoch);
    shmem::wait_block(entry_wait, f.epoch, w, right(), shmem::KIND_BARRIER);
  }

  // before a block's first item of (step, chunk), step > 0: the left
  // neighbour's chunk of step - 1 has landed
  __device__ __forceinline__ void wait_landed(int step, int chunk, int& waited) const {
    const int key = ChunkFlags::slot(step, chunk);
    if (step == 0 || key == waited) return;
    shmem::wait_chunk(f, step - 1, chunk, world, w);
    waited = key;
  }
};

// ----------------------------------------------------------------- K15 ----
// a [m_loc, k] this rank's shard, b [k, n], out [world * m_loc, n]; ws_me
// / ws_right this rank's / the right neighbour's gather workspace [world *
// m_loc, k]. Items of step s, chunk j: fwd[j] forward pieces (none at the
// last step), then tiles[j] GEMM tiles.
template <class E, typename TOut>
__global__ void __launch_bounds__(E::THREADS, 1)
    ring_ag_gemm_kernel(const typename E::TIn* __restrict__ a,
                        const typename E::TIn* __restrict__ b, TOut* __restrict__ out,
                        typename E::TIn* ws_me, typename E::TIn* ws_right, int m_loc, int n,
                        int k, int vec, Spans sp, Ring r) {
  using T = typename E::TIn;
  r.enter();
  const int tiles_n = cdiv(n, E::BN);
  int fwd[shmem::MAX_SPANS], tiles[shmem::MAX_SPANS];
  int per_step = 0, last_step = 0;
  for (int j = 0; j < sp.n; ++j) {
    fwd[j] = static_cast<int>((static_cast<long long>(sp.rows[j]) * k * sizeof(T) +
                               PIECE_BYTES - 1) / PIECE_BYTES);
    tiles[j] = cdiv(sp.rows[j], E::BM) * tiles_n;
    per_step += fwd[j] + tiles[j];
    last_step += tiles[j];
  }
  const int total = (r.world - 1) * per_step + last_step;
  const AddList<TOut> none = {};
  int waited = -1;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int s = min(t / per_step, r.world - 1);
    int rest = t - s * per_step, j = 0;
    bool is_fwd = false;
    for (; j < sp.n; ++j) {
      const int f = s < r.world - 1 ? fwd[j] : 0;
      if (rest < f) {
        is_fwd = true;
        break;
      }
      rest -= f;
      if (rest < tiles[j]) break;
      rest -= tiles[j];
    }
    const int c = (r.me - s + r.world) % r.world;
    const int off = sp.off[j], rows = sp.rows[j];
    r.wait_landed(s, j, waited);
    const T* src = s == 0 ? a + (size_t)off * k : ws_me + ((size_t)c * m_loc + off) * k;
    if (is_fwd) {
      const long long bytes = static_cast<long long>(rows) * k * sizeof(T);
      const long long lo = rest * PIECE_BYTES;
      const long long len = min(PIECE_BYTES, bytes - lo);
      const size_t at = ((size_t)c * m_loc + off) * k * sizeof(T) + lo;
      const unsigned char* from = reinterpret_cast<const unsigned char*>(src) + lo;
      shmem::putmem_nbi_block(reinterpret_cast<unsigned char*>(ws_right) + at, from, len);
      if (s == 0)  // this rank's own shard in its gathered workspace
        shmem::putmem_nbi_block(reinterpret_cast<unsigned char*>(ws_me) + at, from, len);
      shmem::chunk_piece_done(r.f, s, j, fwd[j]);
    } else {
      __syncthreads();  // the previous tile's last reads of shared memory
      const int m0 = (rest / tiles_n) * E::BM, n0 = (rest % tiles_n) * E::BN;
      typename E::Acc acc;
      E::mainloop(src, b, rows, n, k, m0, n0, vec, acc);
      E::template store<false>(acc, out + ((size_t)c * m_loc + off) * n, rows, n, m0, n0, none);
    }
  }
}

// ------------------------------------------------------------- K16/K17 ----
// a [world * m_loc, k] (row chunk c = rows c*m_loc ..), b [k, n], out
// [m_loc, n]; recv_me / recv_right this rank's / the right neighbour's
// landing slots [world - 1, m_loc, n] in the output type. Items of step s,
// chunk j: tiles[j] tiles; step s stores into the right neighbour's slot s
// (the last step into out), adding this rank's landed slot s-1.
template <class E, typename TOut>
__global__ void __launch_bounds__(E::THREADS, 1)
    ring_gemm_rs_kernel(const typename E::TIn* __restrict__ a,
                        const typename E::TIn* __restrict__ b, TOut* __restrict__ out,
                        const TOut* recv_me, TOut* recv_right, int m_loc, int n, int k, int vec,
                        Spans sp, Ring r) {
  r.enter();
  const int tiles_n = cdiv(n, E::BN);
  int tiles[shmem::MAX_SPANS];
  int per_step = 0;
  for (int j = 0; j < sp.n; ++j) {
    tiles[j] = cdiv(sp.rows[j], E::BM) * tiles_n;
    per_step += tiles[j];
  }
  const int total = r.world * per_step;
  const AddList<TOut> none = {};
  int waited = -1;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int s = t / per_step;
    int rest = t - s * per_step, j = 0;
    for (; j < sp.n && rest >= tiles[j]; ++j) rest -= tiles[j];
    const int c = (r.me - 1 - s + 2 * r.world) % r.world;
    const int off = sp.off[j], rows = sp.rows[j];
    const bool last = s == r.world - 1;
    r.wait_landed(s, j, waited);
    __syncthreads();
    const int m0 = (rest / tiles_n) * E::BM, n0 = (rest % tiles_n) * E::BN;
    typename E::Acc acc;
    E::mainloop(a + ((size_t)c * m_loc + off) * k, b, rows, n, k, m0, n0, vec, acc);
    TOut* dst = last ? out + (size_t)off * n : recv_right + ((size_t)s * m_loc + off) * n;
    if (s == 0) {
      E::template store<false>(acc, dst, rows, n, m0, n0, none);
    } else {
      AddList<TOut> landed = {};
      landed.n = 1;
      landed.p[0] = recv_me + ((size_t)(s - 1) * m_loc + off) * n;
      E::template store<true>(acc, dst, rows, n, m0, n0, landed);
    }
    if (!last) shmem::chunk_piece_done(r.f, s, j, tiles[j]);
  }
}

// ----------------------------------------------------------------- K18 ----
// x [world * count] (chunk c = elements c*count ..), out [count]; recv_me /
// recv_right [world - 1, count]. Items of step s: `pieces` element pieces.
template <typename T>
__global__ void ring_reduce_scatter_kernel(const T* __restrict__ x, T* __restrict__ out,
                                           const T* recv_me, T* recv_right, long long count,
                                           Ring r) {
  r.enter();
  const int pieces = static_cast<int>((count + PIECE_ELEMS - 1) / PIECE_ELEMS);
  const int total = r.world * pieces;
  int waited = -1;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int s = t / pieces;
    const long long lo = static_cast<long long>(t - s * pieces) * PIECE_ELEMS;
    const long long hi = min(count, lo + PIECE_ELEMS);
    const int c = (r.me - 1 - s + 2 * r.world) % r.world;
    const bool last = s == r.world - 1;
    r.wait_landed(s, 0, waited);
    const T* xc = x + (size_t)c * count;
    if (s == 0) {
      shmem::putmem_nbi_block(recv_right + lo, xc + lo, (hi - lo) * sizeof(T));
    } else {
      const T* landed = recv_me + (size_t)(s - 1) * count;
      T* dst = last ? out : recv_right + (size_t)s * count;
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
        dst[i] = from_f32<T>(__fadd_rn(to_f32<T>(xc[i]), to_f32<T>(landed[i])));
    }
    if (!last) shmem::chunk_piece_done(r.f, s, 0, pieces);
  }
}

template <typename F>
cudaError_t dispatch_one(int dtype, F&& f) {
  if (dtype == kF32) return f(float{});
  if (dtype == kBF16) return f(bf16{});
  return cudaErrorInvalidValue;
}

int persistent_grid(long long items, int max_blocks) {
  const int cap = max_blocks > 0 ? max_blocks : 1;
  return items < cap ? static_cast<int>(items < 1 ? 1 : items) : cap;
}

bool make_ring(int world, int me, int epoch, void* entry_wait, void* entry_signal,
               void* flags_me, void* flags_right, void* count, void* diag,
               long long timeout_ns, int family, Ring& r) {
  if (world < 2 || world > MAX_WORLD || me < 0 || me >= world) return false;
  r.world = world;
  r.me = me;
  r.entry_wait = static_cast<const int*>(entry_wait);
  r.entry_signal = static_cast<int*>(entry_signal);
  r.f.mine = static_cast<int*>(flags_me);
  r.f.right = static_cast<int*>(flags_right);
  r.f.count = static_cast<int*>(count);
  r.f.epoch = epoch;
  r.w.diag = static_cast<int*>(diag);
  r.w.timeout_ns = timeout_ns;
  r.w.rank = me;
  r.w.family = family;
  return true;
}

bool make_spans(const int* spans, int n_spans, int m_loc, Spans& sp) {
  if (n_spans < 1 || n_spans > shmem::MAX_SPANS) return false;
  int next = 0;
  sp.n = n_spans;
  for (int j = 0; j < shmem::MAX_SPANS; ++j) {
    sp.off[j] = j < n_spans ? spans[2 * j] : 0;
    sp.rows[j] = j < n_spans ? spans[2 * j + 1] : 0;
    if (j < n_spans && (sp.off[j] != next || sp.rows[j] < 1)) return false;
    if (j < n_spans) next += sp.rows[j];
  }
  return next == m_loc;
}

}  // namespace

// K15. spans: host int32[2 * n_spans] of (offset, rows) covering m_loc.
extern "C" int tdt_ring_ag_gemm(const void* a, const void* b, void* out, void* ws_me,
                                void* ws_right, int m_loc, int n, int k, int in_dtype,
                                int out_dtype, const int* spans, int n_spans, int world, int me,
                                void* entry_wait, void* entry_signal, void* flags_me,
                                void* flags_right, void* count, int epoch, int max_blocks,
                                void* diag, long long timeout_ns, int family, void* stream) {
  Ring r;
  Spans sp;
  if (!make_ring(world, me, epoch, entry_wait, entry_signal, flags_me, flags_right, count, diag,
                 timeout_ns, family, r) ||
      !make_spans(spans, n_spans, m_loc, sp) || n < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch_dtypes(in_dtype, out_dtype, [&](auto e, auto t) {
    using E = decltype(e);
    using TOut = decltype(t);
    const int vec = in_dtype == kBF16 ? (bf16_vec_ok(a, b, n, k) && bf16_vec_ok(ws_me, b, n, k))
                                      : 0;
    if (E::SMEM_BYTES > 0) {
      cudaError_t attr = cudaFuncSetAttribute(ring_ag_gemm_kernel<E, TOut>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              E::SMEM_BYTES);
      if (attr != cudaSuccess) return attr;
    }
    ring_ag_gemm_kernel<E, TOut>
        <<<persistent_grid((long long)cdiv(m_loc, E::BM) * cdiv(n, E::BN) * world + world,
                           max_blocks),
           E::THREADS, E::SMEM_BYTES, s>>>(
            static_cast<const typename E::TIn*>(a), static_cast<const typename E::TIn*>(b),
            static_cast<TOut*>(out), static_cast<typename E::TIn*>(ws_me),
            static_cast<typename E::TIn*>(ws_right), m_loc, n, k, vec, sp, r);
    return cudaSuccess;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K16 (one span) and K17. a [world * m_loc, k], out [m_loc, n]; recv_* the
// landing slots [world - 1, m_loc, n] in the output type.
extern "C" int tdt_ring_gemm_rs(const void* a, const void* b, void* out, void* recv_me,
                                void* recv_right, int m_loc, int n, int k, int in_dtype,
                                int out_dtype, const int* spans, int n_spans, int world, int me,
                                void* entry_wait, void* entry_signal, void* flags_me,
                                void* flags_right, void* count, int epoch, int max_blocks,
                                void* diag, long long timeout_ns, int family, void* stream) {
  Ring r;
  Spans sp;
  if (!make_ring(world, me, epoch, entry_wait, entry_signal, flags_me, flags_right, count, diag,
                 timeout_ns, family, r) ||
      !make_spans(spans, n_spans, m_loc, sp) || n < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch_dtypes(in_dtype, out_dtype, [&](auto e, auto t) {
    using E = decltype(e);
    using TOut = decltype(t);
    const int vec = in_dtype == kBF16 ? bf16_vec_ok(a, b, n, k) : 0;
    if (E::SMEM_BYTES > 0) {
      cudaError_t attr = cudaFuncSetAttribute(ring_gemm_rs_kernel<E, TOut>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              E::SMEM_BYTES);
      if (attr != cudaSuccess) return attr;
    }
    ring_gemm_rs_kernel<E, TOut>
        <<<persistent_grid((long long)cdiv(m_loc, E::BM) * cdiv(n, E::BN) * world, max_blocks),
           E::THREADS, E::SMEM_BYTES, s>>>(
            static_cast<const typename E::TIn*>(a), static_cast<const typename E::TIn*>(b),
            static_cast<TOut*>(out), static_cast<const TOut*>(recv_me),
            static_cast<TOut*>(recv_right), m_loc, n, k, vec, sp, r);
    return cudaSuccess;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K18. x [world * count], out [count], recv_* [world - 1, count], one type.
extern "C" int tdt_ring_reduce_scatter(const void* x, void* out, void* recv_me,
                                       void* recv_right, long long count, int dtype, int world,
                                       int me, void* entry_wait, void* entry_signal,
                                       void* flags_me, void* flags_right, void* count_ptr,
                                       int epoch, int max_blocks, void* diag,
                                       long long timeout_ns, int family, void* stream) {
  Ring r;
  if (!make_ring(world, me, epoch, entry_wait, entry_signal, flags_me, flags_right, count_ptr,
                 diag, timeout_ns, family, r) ||
      count < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch_one(dtype, [&](auto t) {
    using T = decltype(t);
    const long long items = world * ((count + PIECE_ELEMS - 1) / PIECE_ELEMS);
    ring_reduce_scatter_kernel<T><<<persistent_grid(items, max_blocks), 256, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), static_cast<const T*>(recv_me),
        static_cast<T*>(recv_right), count, r);
    return cudaSuccess;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
