// The distributed kernels of the tensor-parallel path, all ranks of one
// process (parallel/mesh.py) on one card or on peer-accessible cards:
//
//   K4 tdt_barrier_{arrive,wait}        ≙ ops/common.py:918
//                                         barrier_all_op._kernel
//   K5 tdt_all_gather_{push,collect}    ≙ ops/allgather.py:258
//                                         _full_mesh_push_kernel
//   K6 tdt_ag_gemm_consumer             ≙ ops/allgather_gemm.py:69
//                                         _ag_gemm_kernel
//   K7 tdt_gemm_rs_reduce               ≙ ops/gemm_reduce_scatter.py:99
//                                         _gemm_rs_scatter_kernel (its
//                                         own-chunk GEMM with the n-1
//                                         landed chunks in the epilogue)
//   K9 tdt_ag_group_gemm_consumer       ≙ ops/gg_pipeline.py:288
//                                         make_ag_overlap_kernel, launched
//                                         at ops/allgather_group_gemm.py:235
//                                         (K6's consumer over expert banks)
//   K25 the same, int8 / fp8 banks      ≙ the same kernel under
//                                         OperandFormat.scaled: K24's
//                                         one-byte B stager and scale fold
//   K10 tdt_moe_combine_push,           ≙ ops/gg_pipeline.py:576
//       tdt_moe_rs_reduce                 make_moe_rs_overlap_kernel,
//                                         launched at ops/moe_reduce_rs.py:236
//                                         (its grouped GEMMs are K8,
//                                         csrc/group_gemm.cu)
//   K30 K9/K25 under the ragged-row     ≙ ops/gg_pipeline.py:288 with
//       policy (a valid_rows map)         ragged=True (_ragged_block_emit,
//                                         :218), launched at
//                                         ops/allgather_group_gemm.py:235
//   K31 K10/K26 under the ragged-row    ≙ ops/gg_pipeline.py:576 with
//       policy                            ragged=True (_moe_ragged_blk,
//                                         :253), launched at
//                                         ops/moe_reduce_rs.py:236 (its
//                                         grouped GEMMs are K29)
//   K26 the same, int8 / fp8 W_down     ≙ the same kernel under
//                                         OperandFormat.scaled: its grouped
//                                         GEMMs are K24, whose store folds
//                                         the scale before the combine
//                                         kernel's routing weights multiply
//                                         the rows (gg_pipeline.py:718-721)
//   K32 K9/K25/K30 with spans:          ≙ ops/gg_pipeline.py:288 with
//       tdt_ag_group_gemm_consumer        len(spans) > 1 (the chunk protocol,
//       over a span list                  :398-421), spans from
//                                         ops/common.py:449 resolve_spans
//                                         (launched at
//                                         ops/allgather_group_gemm.py:235)
//   K33 K10/K26/K31 with spans:         ≙ ops/gg_pipeline.py:576 with
//       tdt_moe_combine_push_chunked,     len(spans) > 1 (the chunked push,
//       tdt_moe_rs_reduce_chunked         :746-847), launched at
//                                         ops/moe_reduce_rs.py:236
//   K12 tdt_scatter_reduce              ≙ ops/reduce_scatter.py:227
//                                         _scatter_reduce_kernel, launched
//                                         at :410 (its puts are
//                                         tdt_put_signal)
//
// plus the producer side of K6/K7: tdt_put_signal (copy-engine puts, then
// one flag kernel), and tdt_sleep (a per-rank skew for barrier stress).
// The device surface (puts, signals, bounded waits, barrier) is shmem.cuh.
//
// What bounds them on the H100. K4 and K5 are latency-bound: a barrier is
// one flag round trip through L2 (or NVLink), K5's payload at the served
// shape is 264 KB a rank. K6 and K7 are the K1 GEMM with waits in front of
// its tiles, bound by tensor-core throughput at prefill shapes; so is K9,
// whose B operand hops between experts. K10's combine and reduce stream
// bytes: each destination's [m_out, H] partial is gathered from two f32
// rows a token, written once into the owner's landing slot and read once
// by the owner's reduce. K12 streams bytes: each rank's [m_tot, N] partial
// is read once (n-1 chunks by the copy engines, its own chunk by the
// reduce), the landed chunks once more by the reduce, and its [m_tot / n,
// N] slice written once.
//
// What the design does about it. The ranks share the card and their
// kernels run at once on their own streams, which raises two hazards the
// TPU never had:
//
// - A kernel that spins on a flag holds its SMs. The consumers K6/K7 run a
//   persistent grid of at most floor(SMs / ranks) - 2 blocks, each walking
//   output tiles, so every rank's spinning blocks fit on the card at once
//   with SMs to spare for the small kernels and the producers. The
//   producers move data on copy engines (cudaMemcpyAsync) and set flags
//   with a one-warp kernel, holding no SM while data is in flight.
// - The runtime serialises streams at some calls (a device allocation, a
//   copy within one card): work issued after such a call waits for work
//   issued before it. A kernel that waits for a peer's work issued LATER
//   than itself could then wait forever. So every wait here is for work
//   every rank has already issued: the host meets all ranks (a thread
//   rendezvous, parallel/mesh.py) between issuing the signals and issuing
//   the waits. A barrier is an arrive kernel, the rendezvous, a wait
//   kernel; K5 is a push kernel, the rendezvous, a collect kernel; K6/K7
//   issue their producers, meet, then launch the consumer.
//
// K6 walks shards in arrival order (me, me-1, ...), as the TPU ring does,
// and waits on a shard's flag before the first of its tiles; K9 is the same
// consumer over a gathered workspace of expert-sorted slabs, each M tile
// multiplying the expert bank its row block names. K30 is K9 with the
// ragged map: a tile at or past its block's live count stores zeros and
// skips the mainloop, and a live tile's rows past the count store zeros.
// The shard wait stays before that test, so a block that holds only dead
// tiles of a shard still waits for it: the kernel never ends before every
// slab has landed (the gathered output is whole, and the next call's
// entry barrier cannot overtake a put still in flight). K31 is K10 with
// K29 as each destination's grouped GEMM: the combine reads only the rows
// of real assignments, which are live rows, so its output is K10's bit for
// bit, and every destination's push and flag are raised as before, even
// one whose blocks are all dead. K7 runs its own chunk's
// k loop first and waits for the landed chunks only before the epilogue
// that adds them. K10 is three steps per destination c (own chunk last):
// K8 computes c's aligned rows into a private f32 buffer, the combine
// kernel gathers each token's topk rows and sums them in k order (the
// gather form: deterministic, no atomics) straight into c's landing slot
// for this rank, and a one-warp kernel raises c's flag; after the host
// rendezvous the reduce kernel waits for the peers' flags and sums the n
// slots in rank order in f32. K12 is K7 without the GEMM: the copy engines
// put chunk me+d into landing slot d-1 of rank me+d with a flag each, and
// after the rendezvous the reduce waits for the n-1 flags and sums the own
// chunk, then slots 0 .. n-2 (the TPU kernel's order), in f32, cast once.
// Every wait is bounded (shmem.cuh). K5 moves
// its small payload with SM stores (putmem_signal_nbi_block), one block a
// peer. K5's push, K6, K7 and K12 start with the race-shaking delay
// (shmem.cuh comm_jitter, the JAX kernels' salts 3, 8, 10 and 7), a no-op
// unless the launch asks for it.

#include "gemm_core.cuh"
#include "shmem.cuh"

namespace {

using namespace tdt;
using shmem::MAX_SPANS;
using shmem::Spans;
using shmem::WaitCtx;

constexpr int MAX_WORLD = 8;

// ------------------------------------------------------------------ K4 ----
__global__ void barrier_arrive_kernel(const long long* flags, int world, int me, int epoch) {
  shmem::barrier_arrive_warp(flags, world, me, epoch);
}

__global__ void barrier_wait_kernel(const long long* flags, int world, int me, int epoch,
                                    WaitCtx w) {
  shmem::barrier_wait_warp(flags, world, me, epoch, w);
}

// ------------------------------------------------------------------ K5 ----
// Push (after the entry barrier: every peer's workspace is free): block j
// puts this rank's shard into peer j's workspace slot `me` and signals it;
// block `me` copies the shard to out[me]. Collect: block j waits for peer
// j's shard in this rank's workspace and copies it to out[j].
__global__ void all_gather_push_kernel(const unsigned char* x, unsigned char* out,
                                       long long shard_bytes, const long long* ws,
                                       const long long* data, int world, int me, int epoch,
                                       int jitter) {
  shmem::comm_jitter(me, 3, jitter, world);
  const int j = blockIdx.x;
  if (j == me) {
    shmem::putmem_nbi_block(out + me * shard_bytes, x, shard_bytes);
    return;
  }
  shmem::putmem_signal_nbi_block(shmem::peer_ptr<unsigned char>(ws, j) + me * shard_bytes, x,
                                 shard_bytes, shmem::peer_ptr<int>(data, j) + me, epoch);
}

__global__ void all_gather_collect_kernel(unsigned char* out, long long shard_bytes,
                                          const long long* ws, const long long* data, int world,
                                          int me, int epoch, WaitCtx w) {
  const int j = blockIdx.x;
  if (j == me) return;
  shmem::wait_block(shmem::peer_ptr<int>(data, me) + j, epoch, w, world + j,
                    shmem::KIND_SIGNAL);
  shmem::putmem_nbi_block(out + j * shard_bytes,
                          shmem::peer_ptr<unsigned char>(ws, me) + j * shard_bytes,
                          shard_bytes);
}

// -------------------------------------------------------- K6, K9, K32 ----
// out[c*m_loc:(c+1)*m_loc] = ws[c*m_loc:(c+1)*m_loc] @ b for every shard
// c, shards in arrival order me, me-1, ..., tiles of a shard n-fastest.
// GROUPED (K9): b is an expert bank and the B of a tile is the one its row
// block names in shard c's expert ids (g.ids + c * m_loc / block_m); with
// a one-byte bank (K25) the same expert's scale row folds into the store.
// One span (sp.n 1): one flag a shard, flags[c]. Spans (K32): flag
// flags[c * MAX_SPANS + j] for span j of shard c, waited before the first
// tile of the span, after chunk 0 of the shard.
template <class E, typename TB, typename TOut, bool GROUPED>
__global__ void __launch_bounds__(E::THREADS, 1)
    ag_gemm_kernel(const typename E::TIn* __restrict__ ws, const TB* __restrict__ b,
                   const float* __restrict__ scale, TOut* __restrict__ out, int m_loc, int n,
                   int k, int vec, int world, int me, const int* flags, int epoch, WaitCtx w,
                   Groups g, Spans sp, int jitter) {
  shmem::comm_jitter(me, 8, jitter, world);  // K6's; K9 passes 0
  const int tiles_n = cdiv(n, E::BN);
  const int per_shard = cdiv(m_loc, E::BM) * tiles_n;
  const int total = per_shard * world;
  const AddList<TOut> none = {};
  int waited = -1, waited_shard = -1;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int step = t / per_shard, r = t % per_shard;
    const int c = (me - step + world) % world;
    const int m0 = (r / tiles_n) * E::BM, n0 = (r % tiles_n) * E::BN;
    int slot = c;
    if (sp.n > 1) {
      int j = 0;
      while (j < sp.n - 1 && m0 >= sp.off[j] + sp.rows[j]) ++j;
      slot = c * MAX_SPANS + j;
      if (j > 0 && c != waited_shard)  // chunk 0 first: a late shard names its chunk-0 site
        shmem::wait_block(flags + c * MAX_SPANS, epoch, w, world + c * MAX_SPANS,
                          shmem::KIND_WAIT);
    }
    if (slot != waited) {  // flags only rise: one wait per (shard, span) and block
      shmem::wait_block(flags + slot, epoch, w, world + slot, shmem::KIND_WAIT);
      waited = slot;
      waited_shard = c;
    }
    __syncthreads();  // the previous tile's last reads of shared memory
    TOut* out_c = out + (size_t)c * m_loc * n;
    size_t b_off = 0;
    const float* srow = nullptr;
    int live_end = ALL_ROWS;
    if constexpr (GROUPED) {
      Groups gc = g;
      const int shard_blocks = m_loc / g.block_m;
      gc.ids += c * shard_blocks;
      if (gc.valid) gc.valid += c * shard_blocks;
      const int live = gc.live_rows(m0);
      if (live <= 0) {  // K30: a dead tile, after its shard's wait above
        store_zero_tile<E::BM, E::BN, E::THREADS>(out_c, m_loc, n, m0, n0);
        continue;
      }
      live_end = m0 + live;
      b_off = gc.b_offset(m0, k, n);
      srow = gc.scale_row(scale, m0, n);
    }
    typename E::Acc acc;
    E::mainloop(ws + (size_t)c * m_loc * k, b + b_off, m_loc, n, k, m0, n0, vec, acc);
    E::template store<false>(acc, out_c, m_loc, n, m0, n0, none, srow, live_end);
  }
}

// ------------------------------------------------------------------ K7 ----
// out = a_own @ b + recv[0] + ... + recv[world-2]: the k loop first, then
// one wait for every landed chunk (slot d-1 holds the chunk from rank
// me-d), then the epilogue adds them in slot order in f32.
template <class E, typename TOut>
__global__ void __launch_bounds__(E::THREADS, 1)
    gemm_rs_kernel(const typename E::TIn* __restrict__ a, const typename E::TIn* __restrict__ b,
                   TOut* __restrict__ out, int m_loc, int n, int k, int vec, int world,
                   const int* flags, int epoch, AddList<TOut> adds, WaitCtx w, int jitter) {
  shmem::comm_jitter(w.rank, 10, jitter, world);
  const int tiles_n = cdiv(n, E::BN);
  const int total = cdiv(m_loc, E::BM) * tiles_n;
  bool landed = false;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    __syncthreads();
    const int m0 = (t / tiles_n) * E::BM, n0 = (t % tiles_n) * E::BN;
    typename E::Acc acc;
    E::mainloop(a, b, m_loc, n, k, m0, n0, vec, acc);
    if (!landed) {
      const int d = threadIdx.x;
      if (d < world - 1) shmem::wait_until_ge(flags + d, epoch, w, world + d, shmem::KIND_SIGNAL);
      __threadfence();
      __syncthreads();
      landed = true;
    }
    E::template store<true>(acc, out, m_loc, n, m0, n0, adds);
  }
}

// ----------------------------------------------------------------- K10 ----
// One destination's partial: dst[t, :] = sum_k w[rows[t,k]] * y[rows[t,k], :]
// for the m_out tokens t of the chunk (rows: the aligned row of each
// token's k-th assignment). f32, the products and sums rounded one by one
// in k order, as the plain scatter-add does them; the stores go straight
// into the destination's landing slot (a peer's memory), fenced at
// system scope so the flag raised after this kernel orders after them.
template <typename TOut>
__device__ __forceinline__ void combine_token(const float* __restrict__ y,
                                              const int* __restrict__ rows,
                                              const float* __restrict__ w, TOut* dst, int h,
                                              int topk, int t) {
  const int* r = rows + (size_t)t * topk;
  for (int col = blockIdx.x * blockDim.x + threadIdx.x; col < h; col += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int kk = 0; kk < topk; ++kk) {
      const int row = r[kk];
      acc = __fadd_rn(acc, __fmul_rn(w[row], y[(size_t)row * h + col]));
    }
    dst[(size_t)t * h + col] = from_f32<TOut>(acc);
  }
}

template <typename TOut>
__global__ void moe_combine_kernel(const float* __restrict__ y, const int* __restrict__ rows,
                                   const float* __restrict__ w, TOut* dst, int h, int topk) {
  combine_token(y, rows, w, dst, h, topk, blockIdx.y);
  shmem::quiet();
}

// K33: the same combine for a peer destination, blockIdx.y walking the
// tokens span by span in the list order of `sp`; the block that stores the
// last of span j's gridDim.x * rows[j] pieces raises f's slot j.
template <typename TOut>
__global__ void moe_combine_chunked_kernel(const float* __restrict__ y,
                                           const int* __restrict__ rows,
                                           const float* __restrict__ w, TOut* dst, int h,
                                           int topk, Spans sp, shmem::ChunkFlags f) {
  int i = blockIdx.y, j = 0;
  while (i >= sp.rows[j]) i -= sp.rows[j++];
  combine_token(y, rows, w, dst, h, topk, sp.off[j] + i);
  shmem::chunk_piece_done(f, 0, j, gridDim.x * sp.rows[j]);
}

// out[i] = slots[0][i] + ... + slots[world-1][i] in f32 (slot r: rank r's
// partial of this rank's tokens), once every peer's flag has risen; every
// block waits for every peer before it reads.
template <typename TOut>
__global__ void moe_rs_reduce_kernel(const TOut* __restrict__ slots, TOut* __restrict__ out,
                                     long long count, int world, int me, const int* flags,
                                     int epoch, WaitCtx w) {
  const int d = threadIdx.x;
  if (d < world && d != me) shmem::wait_until_ge(flags + d, epoch, w, world + d, shmem::KIND_SIGNAL);
  __threadfence();
  __syncthreads();
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = to_f32<TOut>(slots[i]);
    for (int r = 1; r < world; ++r) acc = __fadd_rn(acc, to_f32<TOut>(slots[r * count + i]));
    out[i] = from_f32<TOut>(acc);
  }
}

// K33's reduce: the spans in list order; for each, every block waits for
// every peer's slot d * MAX_SPANS + j, then sums the span's rows of the n
// slots in rank order in f32, as K10 does (slot stride `count`).
template <typename TOut>
__global__ void moe_rs_reduce_chunked_kernel(const TOut* __restrict__ slots,
                                             TOut* __restrict__ out, long long count, int h,
                                             int world, int me, const int* flags, Spans sp,
                                             int epoch, WaitCtx w) {
  const int d = threadIdx.x;
  for (int j = 0; j < sp.n; ++j) {
    const int slot = d * MAX_SPANS + j;
    if (d < world && d != me)
      shmem::wait_until_ge(flags + slot, epoch, w, world + slot, shmem::KIND_SIGNAL);
    __threadfence();
    __syncthreads();
    const long long lo = (long long)sp.off[j] * h, hi = lo + (long long)sp.rows[j] * h;
    for (long long i = lo + blockIdx.x * (long long)blockDim.x + threadIdx.x; i < hi;
         i += (long long)gridDim.x * blockDim.x) {
      float acc = to_f32<TOut>(slots[i]);
      for (int r = 1; r < world; ++r) acc = __fadd_rn(acc, to_f32<TOut>(slots[r * count + i]));
      out[i] = from_f32<TOut>(acc);
    }
  }
}

// ----------------------------------------------------------------- K12 ----
// out[i] = own[i] + slots[0][i] + ... + slots[world-2][i] in f32, cast once
// (slot d holds the chunk from rank me-d-1), once the n-1 landing flags
// have risen; every block waits for every flag before it reads.
template <typename T>
__global__ void scatter_reduce_kernel(const T* __restrict__ own, const T* __restrict__ slots,
                                      T* __restrict__ out, long long count, int world,
                                      const int* flags, int epoch, WaitCtx w, int jitter) {
  shmem::comm_jitter(w.rank, 7, jitter, world);
  const int d = threadIdx.x;
  if (d < world - 1) shmem::wait_until_ge(flags + d, epoch, w, world + d, shmem::KIND_SIGNAL);
  __threadfence();
  __syncthreads();
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = to_f32<T>(own[i]);
    for (int s = 0; s < world - 1; ++s) acc = __fadd_rn(acc, to_f32<T>(slots[s * count + i]));
    out[i] = from_f32<T>(acc);
  }
}

template <typename F>
cudaError_t dispatch_out(int out_dtype, F&& f) {
  if (out_dtype == kF32) return f(float{});
  if (out_dtype == kBF16) return f(bf16{});
  return cudaErrorInvalidValue;
}

// the flags a producer sets after its copies, by value in the arguments
struct FlagList {
  long long p[MAX_WORLD];
  int n;
};

__global__ void signal_list_kernel(FlagList f, int value) {
  const int t = threadIdx.x;
  if (t < f.n) shmem::signal_set(reinterpret_cast<int*>(f.p[t]), value);
}

__global__ void sleep_kernel(long long ns) {
  const unsigned long long t0 = shmem::globaltimer();
  while (shmem::globaltimer() - t0 < static_cast<unsigned long long>(ns)) __nanosleep(1000);
}

WaitCtx wait_ctx(void* diag, long long timeout_ns, int rank, int family) {
  WaitCtx w;
  w.diag = static_cast<int*>(diag);
  w.timeout_ns = timeout_ns;
  w.rank = rank;
  w.family = family;
  return w;
}

// grid of a persistent consumer: no more blocks than tiles or than the
// caller's co-residency cap
int persistent_grid(int tiles, int max_blocks) {
  return tiles < max_blocks ? tiles : (max_blocks > 0 ? max_blocks : 1);
}

// A span list (host int32[2 * n]: (offset, rows) pairs) that tiles [0,
// rows) exactly, in any order, into `sp`; `quantum` > 1 also asks for
// ascending spans whose boundaries are multiples of it (K32's tiles).
bool make_spans(const int* spans, int n_spans, int rows, int quantum, Spans& sp) {
  if (n_spans < 1 || n_spans > MAX_SPANS || spans == nullptr) return false;
  sp.n = n_spans;
  long long total = 0;
  for (int j = 0; j < MAX_SPANS; ++j) {
    sp.off[j] = j < n_spans ? spans[2 * j] : 0;
    sp.rows[j] = j < n_spans ? spans[2 * j + 1] : 0;
    if (j >= n_spans) continue;
    if (sp.rows[j] < 1 || sp.off[j] < 0 || sp.off[j] + sp.rows[j] > rows) return false;
    if (quantum > 1 && (sp.off[j] != total || sp.off[j] % quantum != 0)) return false;
    for (int i = 0; i < j; ++i)
      if (sp.off[j] < sp.off[i] + sp.rows[i] && sp.off[i] < sp.off[j] + sp.rows[j]) return false;
    total += sp.rows[j];
  }
  return total == rows;
}

Spans one_span(int rows) {
  Spans sp = {};
  sp.off[0] = 0;
  sp.rows[0] = rows;
  sp.n = 1;
  return sp;
}

}  // namespace

// K4, in two launches: flags is the device peer table of the family's
// int32[world] flags. Every rank's arrive is issued before any wait.
extern "C" int tdt_barrier_arrive(const void* flags, int world, int me, int epoch,
                                  void* stream) {
  if (world < 1 || world > MAX_WORLD) return static_cast<int>(cudaErrorInvalidValue);
  barrier_arrive_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(flags), world, me, epoch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tdt_barrier_wait(const void* flags, int world, int me, int epoch, void* diag,
                                long long timeout_ns, int family, void* stream) {
  if (world < 1 || world > MAX_WORLD) return static_cast<int>(cudaErrorInvalidValue);
  barrier_wait_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(flags), world, me, epoch,
      wait_ctx(diag, timeout_ns, me, family));
  return static_cast<int>(cudaGetLastError());
}

// K5, in two launches: out [world * shard_bytes] private; ws/data device
// peer tables of the workspace [world * shard_bytes] and the int32[world]
// data flags. Every rank's push is issued before any collect.
extern "C" int tdt_all_gather_push(const void* x, void* out, long long shard_bytes,
                                   const void* ws, const void* data, int world, int me,
                                   int epoch, int jitter, void* stream) {
  if (world < 1 || world > MAX_WORLD) return static_cast<int>(cudaErrorInvalidValue);
  all_gather_push_kernel<<<world, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out), shard_bytes,
      static_cast<const long long*>(ws), static_cast<const long long*>(data), world, me, epoch,
      jitter);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tdt_all_gather_collect(void* out, long long shard_bytes, const void* ws,
                                      const void* data, int world, int me, int epoch,
                                      void* diag, long long timeout_ns, int family,
                                      void* stream) {
  if (world < 1 || world > MAX_WORLD) return static_cast<int>(cudaErrorInvalidValue);
  all_gather_collect_kernel<<<world, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned char*>(out), shard_bytes, static_cast<const long long*>(ws),
      static_cast<const long long*>(data), world, me, epoch,
      wait_ctx(diag, timeout_ns, me, family));
  return static_cast<int>(cudaGetLastError());
}

// Copy-engine put of `bytes` from `src` to each of n_dst destinations,
// then one flag kernel that sets each of n_flags flags to `value`
// (putmem_signal on the host side of the stream: the flag write orders
// after the copies by stream order).
extern "C" int tdt_put_signal(int n_dst, const long long* dsts, const void* src,
                              long long bytes, int n_flags, const long long* flags,
                              int value, void* stream) {
  if (n_flags < 0 || n_flags > MAX_WORLD) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n_dst; ++i) {
    cudaError_t err = cudaMemcpyAsync(reinterpret_cast<void*>(dsts[i]), src, bytes,
                                      cudaMemcpyDefault, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  FlagList f;
  f.n = n_flags;
  for (int i = 0; i < MAX_WORLD; ++i) f.p[i] = i < n_flags ? flags[i] : 0;
  signal_list_kernel<<<1, 32, 0, s>>>(f, value);
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <bool GROUPED>
cudaError_t launch_ag_consumer(const void* ws, const void* b, const float* scale, void* out,
                               int m_loc, int n, int k, int in_dtype, int b_dtype,
                               int out_dtype, int world, int me, const void* flags, int epoch,
                               int max_blocks, const WaitCtx& w, const Groups& g,
                               const Spans& sp, int jitter, cudaStream_t s) {
  return dispatch_dtypes(in_dtype, out_dtype, [&](auto e, auto t) {
    using E = decltype(e);
    using TOut = decltype(t);
    auto go = [&](auto wt) {
      using TB = decltype(wt);
      int vec = 0;
      if (in_dtype == kBF16)
        vec = sizeof(TB) == 1 ? (k % 8 == 0 && reinterpret_cast<uintptr_t>(ws) % 16 == 0)
                              : bf16_vec_ok(ws, b, n, k);
      if (E::SMEM_BYTES > 0) {
        cudaError_t attr = cudaFuncSetAttribute(ag_gemm_kernel<E, TB, TOut, GROUPED>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                E::SMEM_BYTES);
        if (attr != cudaSuccess) return attr;
      }
      const int tiles = cdiv(m_loc, E::BM) * cdiv(n, E::BN) * world;
      ag_gemm_kernel<E, TB, TOut, GROUPED>
          <<<persistent_grid(tiles, max_blocks), E::THREADS, E::SMEM_BYTES, s>>>(
              static_cast<const typename E::TIn*>(ws), static_cast<const TB*>(b), scale,
              static_cast<TOut*>(out), m_loc, n, k, vec, world, me,
              static_cast<const int*>(flags), epoch, w, g, sp, jitter);
      return cudaSuccess;
    };
    if constexpr (GROUPED) return dispatch_weights<typename E::TIn>(in_dtype, b_dtype, go);
    else return b_dtype == in_dtype ? go(typename E::TIn{}) : cudaErrorInvalidValue;
  });
}

}  // namespace

// K6: ws [world * m_loc, k] (this rank's gather workspace), b [k, n], out
// [world * m_loc, n]; flags this rank's int32[world] arrival flags.
extern "C" int tdt_ag_gemm_consumer(const void* ws, const void* b, void* out, int m_loc,
                                    int n, int k, int in_dtype, int out_dtype, int world,
                                    int me, const void* flags, int epoch, int max_blocks,
                                    int jitter, void* diag, long long timeout_ns, int family,
                                    void* stream) {
  if (world < 2 || world > MAX_WORLD) return static_cast<int>(cudaErrorInvalidValue);
  const Groups none = {nullptr, 1, 1, nullptr};
  cudaError_t err = launch_ag_consumer<false>(
      ws, b, nullptr, out, m_loc, n, k, in_dtype, in_dtype, out_dtype, world, me, flags, epoch,
      max_blocks, wait_ctx(diag, timeout_ns, me, family), none, one_span(m_loc), jitter,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K9: ws [world * t_pad_loc, k] (the gathered expert-sorted slabs), b
// [n_exp, k, n], expert_ids int32 [world, t_pad_loc / block_m], out
// [world * t_pad_loc, n]; block_m a multiple of 128 dividing t_pad_loc. K25:
// b int8 / fp8 e4m3 (b_dtype) with its f32 scale bank [n_exp, 1, n] (n a
// multiple of 16, b 16-byte aligned); otherwise b in the slabs' type and
// scale null. K30: valid_rows int32 [world, t_pad_loc / block_m], each
// block's live rows (null: padded). spans: host int32[2 * n_spans], the
// (offset, rows) spans of a slab, ascending, contiguous, boundaries
// multiples of 128; one span: flags is this rank's int32[world] arrival
// flags (K9/K25/K30); more (K32): its int32[world * MAX_SPANS] (source,
// span) flags.
extern "C" int tdt_ag_group_gemm_consumer(const void* ws, const void* b, const void* scale,
                                          const void* expert_ids, const void* valid_rows,
                                          void* out, int t_pad_loc,
                                          int n, int k, int n_exp, int block_m, int in_dtype,
                                          int b_dtype, int out_dtype, const int* spans,
                                          int n_spans, int world, int me,
                                          const void* flags, int epoch, int max_blocks,
                                          void* diag, long long timeout_ns, int family,
                                          void* stream) {
  const bool scaled = b_dtype == kI8 || b_dtype == kFP8;
  Spans sp;
  if (world < 2 || world > MAX_WORLD || block_m <= 0 || block_m % 128 != 0 ||
      t_pad_loc % block_m != 0 || n_exp < 1 || scaled != (scale != nullptr) ||
      (scaled && !byte_b_ok(b, n)) || !make_spans(spans, n_spans, t_pad_loc, 128, sp))
    return static_cast<int>(cudaErrorInvalidValue);
  const Groups g = {static_cast<const int*>(expert_ids), block_m, n_exp,
                    static_cast<const int*>(valid_rows)};
  cudaError_t err = launch_ag_consumer<true>(
      ws, b, static_cast<const float*>(scale), out, t_pad_loc, n, k, in_dtype, b_dtype,
      out_dtype, world, me, flags, epoch, max_blocks, wait_ctx(diag, timeout_ns, me, family), g,
      sp, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K7: a [m_loc, k] (this rank's own row chunk of A), b [k, n], out
// [m_loc, n]; recv: host array of the world-1 landing slots [m_loc, n] in
// the output type; flags this rank's int32[world-1] landing flags.
extern "C" int tdt_gemm_rs_reduce(const void* a, const void* b, void* out, int m_loc, int n,
                                  int k, int in_dtype, int out_dtype, int world,
                                  const void* const* recv, int me, const void* flags,
                                  int epoch, int max_blocks, int jitter, void* diag,
                                  long long timeout_ns, int family, void* stream) {
  if (world < 2 || world > MAX_WORLD) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WaitCtx w = wait_ctx(diag, timeout_ns, me, family);
  cudaError_t err = dispatch_dtypes(in_dtype, out_dtype, [&](auto e, auto t) {
    using E = decltype(e);
    using TOut = decltype(t);
    const int vec = in_dtype == kBF16 ? bf16_vec_ok(a, b, n, k) : 0;
    if (E::SMEM_BYTES > 0) {
      cudaError_t attr = cudaFuncSetAttribute(gemm_rs_kernel<E, TOut>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              E::SMEM_BYTES);
      if (attr != cudaSuccess) return attr;
    }
    const int tiles = cdiv(m_loc, E::BM) * cdiv(n, E::BN);
    gemm_rs_kernel<E, TOut><<<persistent_grid(tiles, max_blocks), E::THREADS, E::SMEM_BYTES, s>>>(
        static_cast<const typename E::TIn*>(a), static_cast<const typename E::TIn*>(b),
        static_cast<TOut*>(out), m_loc, n, k, vec, world, static_cast<const int*>(flags),
        epoch, make_adds<TOut>(recv, world - 1), w, jitter);
    return cudaSuccess;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K10, the combine of one destination: y [t_pad_loc, h] f32 (that
// destination's grouped-GEMM rows), rows int32 [m_out, topk], w f32
// [t_pad_loc], dst [m_out, h] in the output type (the destination's
// landing slot for this rank).
extern "C" int tdt_moe_combine_push(const void* y, const void* rows, const void* w, void* dst,
                                    int m_out, int h, int topk, int out_dtype, void* stream) {
  if (m_out < 0 || m_out > 65535 || h < 1 || topk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m_out == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch_out(out_dtype, [&](auto t) {
    using TOut = decltype(t);
    const dim3 grid(cdiv(h, 256) < 8 ? cdiv(h, 256) : 8, m_out);
    moe_combine_kernel<TOut><<<grid, 256, 0, s>>>(
        static_cast<const float*>(y), static_cast<const int*>(rows),
        static_cast<const float*>(w), static_cast<TOut*>(dst), h, topk);
    return cudaSuccess;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K33, the combine of one peer destination span by span: the arguments of
// tdt_moe_combine_push, the spans (host int32[2 * n_spans] (offset, rows)
// tiling [0, m_out), in the policy's list order), peer_flags the
// destination's int32[MAX_SPANS] slots of this rank (slot j for span j),
// count this rank's int32[MAX_SPANS] piece counts for that destination
// (zero between launches), epoch the launch's.
extern "C" int tdt_moe_combine_push_chunked(const void* y, const void* rows, const void* w,
                                            void* dst, int m_out, int h, int topk,
                                            int out_dtype, const int* spans, int n_spans,
                                            void* peer_flags, void* count, int epoch,
                                            void* stream) {
  Spans sp;
  if (m_out < 1 || m_out > 65535 || h < 1 || topk < 1 || peer_flags == nullptr ||
      count == nullptr || !make_spans(spans, n_spans, m_out, 1, sp))
    return static_cast<int>(cudaErrorInvalidValue);
  const shmem::ChunkFlags f = {nullptr, static_cast<int*>(peer_flags), static_cast<int*>(count),
                               epoch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch_out(out_dtype, [&](auto t) {
    using TOut = decltype(t);
    const dim3 grid(cdiv(h, 256) < 8 ? cdiv(h, 256) : 8, m_out);
    moe_combine_chunked_kernel<TOut><<<grid, 256, 0, s>>>(
        static_cast<const float*>(y), static_cast<const int*>(rows),
        static_cast<const float*>(w), static_cast<TOut*>(dst), h, topk, sp, f);
    return cudaSuccess;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K33, the owner's reduce: slots [world, m_out, h] in the output type (this
// rank's landing slots), out [m_out, h]; flags this rank's int32[world *
// MAX_SPANS] (source, span) flags; the spans as for the combine.
extern "C" int tdt_moe_rs_reduce_chunked(const void* slots, void* out, int m_out, int h,
                                         int out_dtype, int world, int me, const void* flags,
                                         const int* spans, int n_spans, int epoch,
                                         int max_blocks, void* diag, long long timeout_ns,
                                         int family, void* stream) {
  Spans sp;
  if (world < 2 || world > MAX_WORLD || m_out < 1 || h < 1 ||
      !make_spans(spans, n_spans, m_out, 1, sp))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WaitCtx w = wait_ctx(diag, timeout_ns, me, family);
  const long long count = (long long)m_out * h;
  cudaError_t err = dispatch_out(out_dtype, [&](auto t) {
    using TOut = decltype(t);
    int widest = 0;
    for (int j = 0; j < n_spans; ++j) widest = sp.rows[j] > widest ? sp.rows[j] : widest;
    const long long want = ((long long)widest * h + 255) / 256;
    const int blocks = persistent_grid(want < (1 << 30) ? static_cast<int>(want) : (1 << 30),
                                       max_blocks);
    moe_rs_reduce_chunked_kernel<TOut><<<blocks, 256, 0, s>>>(
        static_cast<const TOut*>(slots), static_cast<TOut*>(out), count, h, world, me,
        static_cast<const int*>(flags), sp, epoch, w);
    return cudaSuccess;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K10, the owner's reduce: slots [world, count] in the output type (this
// rank's landing slots), out [count]; flags this rank's int32[world]
// landing flags (slot me is its own, written earlier on this stream).
extern "C" int tdt_moe_rs_reduce(const void* slots, void* out, long long count, int out_dtype,
                                 int world, int me, const void* flags, int epoch,
                                 int max_blocks, void* diag, long long timeout_ns, int family,
                                 void* stream) {
  if (world < 2 || world > MAX_WORLD) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WaitCtx w = wait_ctx(diag, timeout_ns, me, family);
  cudaError_t err = dispatch_out(out_dtype, [&](auto t) {
    using TOut = decltype(t);
    const long long want = (count + 255) / 256;
    const int blocks = persistent_grid(want < (1 << 30) ? static_cast<int>(want) : (1 << 30),
                                       max_blocks);
    moe_rs_reduce_kernel<TOut><<<blocks, 256, 0, s>>>(
        static_cast<const TOut*>(slots), static_cast<TOut*>(out), count, world, me,
        static_cast<const int*>(flags), epoch, w);
    return cudaSuccess;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K12, the owner's reduce: own [count] (this rank's own chunk of its
// partial), slots [world-1, count] (its landing slots), out [count], all in
// one type; flags this rank's int32[world-1] landing flags.
extern "C" int tdt_scatter_reduce(const void* own, const void* slots, void* out,
                                  long long count, int dtype, int world, int me,
                                  const void* flags, int epoch, int max_blocks, int jitter,
                                  void* diag, long long timeout_ns, int family,
                                  void* stream) {
  if (world < 2 || world > MAX_WORLD || count < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WaitCtx w = wait_ctx(diag, timeout_ns, me, family);
  cudaError_t err = dispatch_out(dtype, [&](auto t) {
    using T = decltype(t);
    const long long want = (count + 255) / 256;
    const int blocks = persistent_grid(want < (1 << 30) ? static_cast<int>(want) : (1 << 30),
                                       max_blocks);
    scatter_reduce_kernel<T><<<blocks, 256, 0, s>>>(
        static_cast<const T*>(own), static_cast<const T*>(slots), static_cast<T*>(out), count,
        world, static_cast<const int*>(flags), epoch, w, jitter);
    return cudaSuccess;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tdt_sleep(long long ns, void* stream) {
  sleep_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(ns);
  return static_cast<int>(cudaGetLastError());
}

// A non-blocking stream of its own for a rank (high priority for the comm
// streams, so the block scheduler serves the producers first). Streams
// created one after the other get distinct hardware queues (up to
// CUDA_DEVICE_MAX_CONNECTIONS), so one rank's spinning kernel never sits
// in front of a peer's producer in a shared queue.
extern "C" int tdt_stream_create(int high_priority, void** out) {
  int least = 0, greatest = 0;
  cudaError_t err = cudaDeviceGetStreamPriorityRange(&least, &greatest);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamCreateWithPriority(reinterpret_cast<cudaStream_t*>(out),
                                                       cudaStreamNonBlocking,
                                                       high_priority ? greatest : least));
}

// Peer access between two cards (UVA pointers into the peer's memory);
// already-enabled counts as success.
extern "C" int tdt_enable_peer_access(int device, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  cudaSetDevice(prev);
  return static_cast<int>(err);
}

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
