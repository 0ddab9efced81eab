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
//       (one span)
//   K23 tdt_ring_reduce_scatter   ≙ ops/reduce_scatter.py:152
//       (spans)                     _ring_rs_chunked_kernel
//   K19 tdt_ring_all_gather       ≙ ops/allgather.py:73 _ring_1d_kernel
//       (one direction, one span)
//   K20 (one direction, spans)    ≙ ops/allgather.py:144 _ring_1d_chunked_kernel
//   K21 (two directions, one      ≙ ops/allgather.py:102 _ring_bidir_kernel
//       span)
//   K22 (two directions, spans)   ≙ ops/allgather.py:191
//                                   _ring_bidir_chunked_kernel
//   K36 tdt_ring_all_gather_2d    ≙ ops/allgather.py:284 _ring_2d_kernel
//   K37 tdt_ring_ag_gemm_2d       ≙ ops/allgather_gemm.py:179
//                                   _ag_gemm_2d_kernel
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
// kernels' (gemm_add_pipeline, ops/common.py:468, casts at every hop). K23
// is K18 per span: span j of step s goes on as soon as span j of the left
// partial has landed; every element keeps K18's hop order and its rounding
// per hop, so K23 equals K18 bit for bit. K19-K22 gather the ranks' shards:
// going right, step s forwards shard me-s to the right neighbour (n-1 steps
// in the one-way ring, ceil((n-1)/2) in the bidirectional one); going left,
// step s forwards shard me+s to the left neighbour (floor((n-1)/2) steps,
// none at world 2); span j of step s > 0 goes on once span j of step s-1
// has landed, and each landed shard is copied to out. K36 gathers over a
// pair group (outer, inner) of n_o * n_i ranks, rank (o, i) = o * n_i + i,
// shard (o, i) at rows (o * n_i + i) * m of out: an inner ring gathers this
// rank's row o, and every chunk goes on down the outer ring the moment it
// is here. Inner step s moves chunk (me_o, me_i - s): it is copied to out,
// put to the right inner neighbour (s < n_i - 1) and down the outer ring
// (outer round 0). Outer round t >= 1 moves chunk (me_o - t, me_i - s) for
// s = 0 .. n_i - 1 as it lands from above: to out, and on down unless t is
// the last round. The ranks of an outer ring share their inner index, so
// sender and receiver name a chunk by the same (t, s) flag slot. K37 is
// K36's forwarding into the gather workspace with K15's GEMM tiles on each
// chunk after its forwards, in that 2-D arrival order.
//
// What bounds them on the H100. K15-K17 are K1's tile loop (gemm_core.cuh)
// with waits in front of a chunk's tiles: tensor-core throughput at prefill
// shapes. K18/K23 stream bytes: each rank reads its n chunks once, the
// landed partials once, and writes n-1 hops plus its own chunk. K19-K22
// stream bytes too: each rank reads every shard once (its own from x, the
// others from its workspace as they land) and writes it once into out and,
// unless the shard ends its trip here, once into a neighbour's workspace.
//
// The design. A ring step waits on the left neighbour's previous step, so
// the waits sit inside the kernel that issues the puts: one persistent
// kernel per rank per call, of at most floor(SMs / ranks) - 2 blocks (the
// caller's cap), so every rank's blocks are resident together. Its work is
// one list of items in (step, chunk) order, dealt to the blocks
// round-robin: K15 a chunk's forward pieces then its GEMM tiles, K16/K17 a
// chunk's tiles, K18/K23 a span's element pieces, K19-K22 a span's byte
// pieces (the bidirectional ring lists a step's right-moving spans, then
// its left-moving ones). An item of step s > 0 first waits (bounded,
// shmem.cuh wait_chunk) for the sending neighbour's chunk of step s-1,
// which sits earlier in that neighbour's list, so by induction over the
// steps every wait is met. Every store towards the
// right neighbour goes straight into its landing view through the peer
// table (K16/K17's epilogue, K15's, K18's and the gathers' pieces): no send
// buffer, no reuse wait. The block that finishes a chunk's last piece
// raises the neighbour's (step, chunk) flag (chunk_piece_done); the
// bidirectional ring keeps a second flag set for the chunks that travel
// left (per direction, not per neighbour: at world 2 both neighbours are
// one rank). Each slot of the landing buffers is written once per call;
// across calls the neighbour's arrival guards them: a kernel first tells
// its left neighbour it has started (so its reads of the previous call are
// over), and every block waits for the right neighbour's arrival before
// anything else. The bidirectional ring stores into both neighbours, so
// its blocks first complete barrier_neighbors: right neighbour, then left,
// so a missing neighbour is always named by the same site. Every ring
// kernel starts with the race-shaking delay (shmem.cuh comm_jitter, the
// JAX kernels' salts: gathers 1 and 2, reduce-scatter 6, AG-GEMM 8,
// GEMM-RS 11), a no-op unless the launch asks for it.
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
using shmem::make_ring;
using shmem::Ring;
using shmem::Spans;
using shmem::WaitCtx;

constexpr long long PIECE_BYTES = 256 * 1024;  // one forward piece of K15
constexpr long long PIECE_ELEMS = 64 * 1024;   // one element piece of K18/K23
constexpr long long GATHER_PIECE = 32 * 1024;  // one byte piece of K19-K22

// The bidirectional ring's second half: the flag set of the chunks that
// travel left (this rank's slots raised by its right neighbour, the left
// neighbour's raised by this rank) and the entry handshake's other side.
struct RingLeft {
  const int* entry_wait;  // this rank's slot of its left neighbour's arrival
  int* entry_signal;      // the right neighbour's slot of this rank's arrival
  ChunkFlags f;
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
  shmem::comm_jitter(r.me, 8, r.jitter, r.world);
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
  shmem::comm_jitter(r.me, 11, r.jitter, r.world);
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

// ------------------------------------------------------------- K18/K23 ----
// x [world * m_loc, n] (row chunk c = rows c*m_loc ..), out [m_loc, n];
// recv_me / recv_right [world - 1, m_loc, n]. Items of step s, span j:
// pieces[j] element pieces of the span's rows. The adds are element-wise,
// so how the spans cut the rows changes no result.
template <typename T>
__global__ void ring_reduce_scatter_kernel(const T* __restrict__ x, T* __restrict__ out,
                                           const T* recv_me, T* recv_right, int m_loc,
                                           long long n, Spans sp, Ring r) {
  shmem::comm_jitter(r.me, 6, r.jitter, r.world);
  r.enter();
  const long long count = m_loc * n;
  int pieces[shmem::MAX_SPANS];
  int per_step = 0;
  for (int j = 0; j < sp.n; ++j) {
    pieces[j] = static_cast<int>((sp.rows[j] * n + PIECE_ELEMS - 1) / PIECE_ELEMS);
    per_step += pieces[j];
  }
  const int total = r.world * per_step;
  int waited = -1;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int s = t / per_step;
    int rest = t - s * per_step, j = 0;
    for (; j < sp.n && rest >= pieces[j]; ++j) rest -= pieces[j];
    const long long end = (sp.off[j] + sp.rows[j]) * n;
    const long long lo = sp.off[j] * n + static_cast<long long>(rest) * PIECE_ELEMS;
    const long long hi = min(end, lo + PIECE_ELEMS);
    const int c = (r.me - 1 - s + 2 * r.world) % r.world;
    const bool last = s == r.world - 1;
    r.wait_landed(s, j, waited);
    const T* xc = x + (size_t)c * count;
    if (s == 0) {
      shmem::putmem_nbi_block(recv_right + lo, xc + lo, (hi - lo) * sizeof(T));
    } else {
      const T* landed = recv_me + (size_t)(s - 1) * count;
      T* dst = last ? out : recv_right + (size_t)s * count;
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
        dst[i] = from_f32<T>(__fadd_rn(to_f32<T>(xc[i]), to_f32<T>(landed[i])));
    }
    if (!last) shmem::chunk_piece_done(r.f, s, j, pieces[j]);
  }
}

// -------------------------------------------------------------- K19-K22 ----
// The block copies `bytes` from `src` into `out` and into `fwd` (one load,
// two stores), either of which may be null: 16-byte vectors while every
// pointer is 16-byte aligned, bytes for the tail.
__device__ __forceinline__ void copy2_block(unsigned char* out, unsigned char* fwd,
                                            const unsigned char* src, long long bytes) {
  const bool vec = (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(fwd) % 16 == 0);
  long long done = 0;
  if (vec) {
    const long long n16 = bytes / 16;
    const uint4* s16 = reinterpret_cast<const uint4*>(src);
    for (long long i = threadIdx.x; i < n16; i += blockDim.x) {
      const uint4 v = s16[i];
      if (out) reinterpret_cast<uint4*>(out)[i] = v;
      if (fwd) reinterpret_cast<uint4*>(fwd)[i] = v;
    }
    done = n16 * 16;
  }
  for (long long i = done + threadIdx.x; i < bytes; i += blockDim.x) {
    const unsigned char v = src[i];
    if (out) out[i] = v;
    if (fwd) fwd[i] = v;
  }
}

// x [m rows of row_bytes] this rank's shard, out [world * m rows]; ws_me /
// ws_right / ws_left this rank's and its neighbours' gather workspaces
// [world * m rows]. Direction 0 carries shards right (shard me-s at step
// s), direction 1 left (shard me+s). A direction with `steps` forwarding
// steps lists steps 0 .. steps: step s < steps copies its shard to out and
// forwards it, the last one copies its landed shard to out only. Items of
// step s: for each direction that has it, for each span j, pieces[j] byte
// pieces. Shard me goes to out once, in direction 0's step 0.
__global__ void ring_all_gather_kernel(const unsigned char* __restrict__ x,
                                       unsigned char* __restrict__ out,
                                       const unsigned char* ws_me, unsigned char* ws_right,
                                       unsigned char* ws_left, long long row_bytes, Spans sp,
                                       int m, int dirs, Ring r, RingLeft rl) {
  shmem::comm_jitter(r.me, dirs == 2 ? 2 : 1, r.jitter, r.world);
  if (dirs == 2) {
    const shmem::Neighbours nb = {r.entry_signal, rl.entry_signal, r.entry_wait,
                                  rl.entry_wait,  r.left(),        r.right()};
    shmem::barrier_neighbors(nb, r.f.epoch, r.w);
  } else {
    r.enter();
  }
  const int n = r.world;
  const int steps[2] = {dirs == 2 ? n / 2 : n - 1, dirs == 2 ? (n - 1) / 2 : 0};
  int pieces[shmem::MAX_SPANS];
  int per_dir = 0;
  for (int j = 0; j < sp.n; ++j) {
    pieces[j] = static_cast<int>((sp.rows[j] * row_bytes + GATHER_PIECE - 1) / GATHER_PIECE);
    per_dir += pieces[j];
  }
  int total = 0;
  for (int d = 0; d < 2; ++d) total += steps[d] > 0 ? (steps[d] + 1) * per_dir : 0;
  const long long shard = m * row_bytes;
  int waited = -1;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    // (step, direction) of item t: step-major, direction 0 first
    int rest = t, s = 0, d = 0;
    for (;; ++s) {
      if (s <= steps[0]) {
        if (rest < per_dir) break;
        rest -= per_dir;
      }
      if (s <= steps[1] && steps[1] > 0) {
        if (rest < per_dir) {
          d = 1;
          break;
        }
        rest -= per_dir;
      }
    }
    int j = 0;
    for (; j < sp.n && rest >= pieces[j]; ++j) rest -= pieces[j];
    const ChunkFlags& f = d == 0 ? r.f : rl.f;
    const int c = d == 0 ? (r.me - s + n) % n : (r.me + s) % n;
    if (s > 0) {
      const int key = d * n * shmem::MAX_SPANS + ChunkFlags::slot(s, j);
      if (key != waited) {
        shmem::wait_chunk(f, s - 1, j, d == 0 ? n : n + (n - 1) * shmem::MAX_SPANS, r.w);
        waited = key;
      }
    }
    const long long lo = static_cast<long long>(rest) * GATHER_PIECE;
    const long long len = min(GATHER_PIECE, sp.rows[j] * row_bytes - lo);
    const long long at = c * shard + sp.off[j] * row_bytes + lo;
    const unsigned char* src = s == 0 ? x + sp.off[j] * row_bytes + lo : ws_me + at;
    const bool forward = s < steps[d];
    copy2_block(d == 1 && s == 0 ? nullptr : out + at,
                forward ? (d == 0 ? ws_right : ws_left) + at : nullptr, src, len);
    if (forward) shmem::chunk_piece_done(f, s, j, pieces[j]);
  }
}

// ------------------------------------------------------------- K36/K37 ----
// One rank's side of a launch over a pair group: its place, the entry
// barrier over the whole group (the reference's barrier_all over (outer,
// inner)), the inner flags (slot s: the chunk of inner step s) and the
// outer flags (slot t * MAX_SPANS + s: inner chunk s of outer round t).
struct Ring2D {
  int n_o, n_i, world, me, me_o, me_i;
  const long long* entry_table;  // the peers' entry flag sets (int32[world] each)
  const int* entry_mine;         // this rank's entry flag set
  ChunkFlags in, out;
  WaitCtx w;
  int jitter;

  // every rank of the group has started (its reads of the previous call's
  // workspace are over) before any store into a peer: block 0 raises this
  // rank's slot in every peer's set, every block waits for the peers in
  // rank order, so a late rank is named by the same site on every rank
  __device__ __forceinline__ void enter() const {
    const int epoch = in.epoch;
    if (blockIdx.x == 0 && threadIdx.x < world && threadIdx.x != me)
      shmem::signal_set(shmem::peer_ptr<int>(entry_table, threadIdx.x) + me, epoch);
    if (threadIdx.x == 0) {
      for (int p = 0; p < world; ++p)
        if (p != me && !shmem::wait_until_ge(entry_mine + p, epoch, w, p, shmem::KIND_BARRIER))
          break;
      __threadfence();
    }
    __syncthreads();
  }

  // the chunk of item (t, s) has landed here; (0, 0) is this rank's own
  __device__ __forceinline__ void wait_chunk(int t, int s, int& waited) const {
    const int key = t * shmem::MAX_SPANS + s;
    if ((t == 0 && s == 0) || key == waited) return;
    if (t == 0)
      shmem::wait_chunk(in, 0, s - 1, world, w);
    else
      shmem::wait_chunk(out, t - 1, s, world + shmem::MAX_SPANS, w);
    waited = key;
  }

  // the out slot (row block) of item (t, s)
  __device__ __forceinline__ int slot(int t, int s) const {
    return ((me_o - t + n_o) % n_o) * n_i + (me_i - s + n_i) % n_i;
  }
};

// The block copies `bytes` from `src` into each non-null destination (one
// load, up to three stores): 16-byte vectors while every pointer is
// 16-byte aligned, bytes for the tail.
__device__ __forceinline__ void copy3_block(unsigned char* d0, unsigned char* d1,
                                            unsigned char* d2, const unsigned char* src,
                                            long long bytes) {
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  long long done = 0;
  if (al(src) && al(d0) && al(d1) && al(d2)) {
    const long long n16 = bytes / 16;
    const uint4* s16 = reinterpret_cast<const uint4*>(src);
    for (long long i = threadIdx.x; i < n16; i += blockDim.x) {
      const uint4 v = s16[i];
      if (d0) reinterpret_cast<uint4*>(d0)[i] = v;
      if (d1) reinterpret_cast<uint4*>(d1)[i] = v;
      if (d2) reinterpret_cast<uint4*>(d2)[i] = v;
    }
    done = n16 * 16;
  }
  for (long long i = done + threadIdx.x; i < bytes; i += blockDim.x) {
    const unsigned char v = src[i];
    if (d0) d0[i] = v;
    if (d1) d1[i] = v;
    if (d2) d2[i] = v;
  }
}

// One forward piece of item (t, s): bytes [lo, lo + len) of its chunk, from
// `src` to `local` (out, or this rank's workspace; may be null) and to the
// neighbours it goes on to, then the signals of the chunks that piece
// completes. `shard` is a chunk's size in bytes, at = its slot's offset.
__device__ __forceinline__ void forward_piece_2d(const Ring2D& r, int t, int s,
                                                 const unsigned char* src, unsigned char* local,
                                                 unsigned char* ws_right, unsigned char* ws_down,
                                                 size_t at, long long lo, long long len,
                                                 int pieces) {
  const bool fwd_in = t == 0 && s < r.n_i - 1;
  const bool fwd_out = t < r.n_o - 1;
  copy3_block(local ? local + lo : nullptr, fwd_in ? ws_right + at + lo : nullptr,
              fwd_out ? ws_down + at + lo : nullptr, src + lo, len);
  if (fwd_in) shmem::chunk_piece_done(r.in, 0, s, pieces);
  if (fwd_out) shmem::chunk_piece_done(r.out, t, s, pieces);
}

// K36. x [m rows of row_bytes] this rank's shard, out [world * m rows];
// ws_me / ws_right / ws_down this rank's, its right inner neighbour's and
// its outer neighbour below's gather workspaces [world * m rows]. Items
// in 2-D arrival order: (0, s) for s < n_i, then (t, s) for 1 <= t < n_o;
// each item is `pieces` byte pieces of its chunk.
__global__ void ring_all_gather_2d_kernel(const unsigned char* __restrict__ x,
                                          unsigned char* __restrict__ out,
                                          const unsigned char* ws_me, unsigned char* ws_right,
                                          unsigned char* ws_down, long long shard, Ring2D r) {
  shmem::comm_jitter(r.me, 4, r.jitter, r.world);
  r.enter();
  const int pieces = static_cast<int>((shard + GATHER_PIECE - 1) / GATHER_PIECE);
  const int total = r.world * pieces;
  int waited = -1;
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    const int chunk = item / pieces, rest = item % pieces;
    const int t = chunk / r.n_i, s = chunk % r.n_i;
    r.wait_chunk(t, s, waited);
    const size_t at = static_cast<size_t>(r.slot(t, s)) * shard;
    const unsigned char* src = (t == 0 && s == 0) ? x : ws_me + at;
    const long long lo = static_cast<long long>(rest) * GATHER_PIECE;
    forward_piece_2d(r, t, s, src, out + at, ws_right, ws_down, at, lo,
                     min(GATHER_PIECE, shard - lo), pieces);
  }
}

// K37. a [m_loc, k] this rank's shard, b [k, n], out [world * m_loc, n];
// ws_* the gather workspaces [world * m_loc, k] as K36's. Items of chunk
// (t, s) in K36's order: fwd forward pieces (none when the chunk goes no
// further), then its GEMM tiles, K15's tile loop over the chunk's rows.
template <class E, typename TOut>
__global__ void __launch_bounds__(E::THREADS, 1)
    ring_ag_gemm_2d_kernel(const typename E::TIn* __restrict__ a,
                           const typename E::TIn* __restrict__ b, TOut* __restrict__ out,
                           typename E::TIn* ws_me, typename E::TIn* ws_right,
                           typename E::TIn* ws_down, int m_loc, int n, int k, int vec,
                           Ring2D r) {
  using T = typename E::TIn;
  shmem::comm_jitter(r.me, 9, r.jitter, r.world);
  r.enter();
  const long long shard = static_cast<long long>(m_loc) * k * sizeof(T);
  const int fwd = static_cast<int>((shard + PIECE_BYTES - 1) / PIECE_BYTES);
  const int tiles_n = cdiv(n, E::BN);
  const int tiles = cdiv(m_loc, E::BM) * tiles_n;
  const AddList<TOut> none = {};
  int per_chunk[shmem::RING_MAX_WORLD], total = 0;
  for (int c = 0; c < r.world; ++c) {
    const int t = c / r.n_i, s = c % r.n_i;
    // the own chunk always lands in this rank's workspace too
    const bool moves = (t == 0 && s < r.n_i - 1) || t < r.n_o - 1 || c == 0;
    per_chunk[c] = (moves ? fwd : 0) + tiles;
    total += per_chunk[c];
  }
  int waited = -1;
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    int c = 0, rest = item;
    for (; rest >= per_chunk[c]; ++c) rest -= per_chunk[c];
    const int t = c / r.n_i, s = c % r.n_i;
    const int n_fwd = per_chunk[c] - tiles;
    r.wait_chunk(t, s, waited);
    const size_t row0 = static_cast<size_t>(r.slot(t, s)) * m_loc;
    const T* src = (t == 0 && s == 0) ? a : ws_me + row0 * k;
    if (rest < n_fwd) {
      const long long lo = static_cast<long long>(rest) * PIECE_BYTES;
      forward_piece_2d(r, t, s, reinterpret_cast<const unsigned char*>(src),
                       (t == 0 && s == 0) ? reinterpret_cast<unsigned char*>(ws_me) +
                                                row0 * k * sizeof(T)
                                          : nullptr,
                       reinterpret_cast<unsigned char*>(ws_right),
                       reinterpret_cast<unsigned char*>(ws_down), row0 * k * sizeof(T), lo,
                       min(PIECE_BYTES, shard - lo), n_fwd);
    } else {
      rest -= n_fwd;
      __syncthreads();  // the previous tile's last reads of shared memory
      const int m0 = (rest / tiles_n) * E::BM, n0 = (rest % tiles_n) * E::BN;
      typename E::Acc acc;
      E::mainloop(src, b, m_loc, n, k, m0, n0, vec, acc);
      E::template store<false>(acc, out + row0 * n, m_loc, n, m0, n0, none);
    }
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

// A Ring2D from the host's launch arguments; false for a group it cannot be.
bool make_ring_2d(int n_o, int n_i, int me, int epoch, void* entry_table, void* entry_mine,
                  void* in_mine, void* in_peer, void* in_count, void* out_mine, void* out_peer,
                  void* out_count, int jitter, void* diag, long long timeout_ns, int family,
                  Ring2D& r) {
  const int world = n_o * n_i;
  if (n_o < 1 || n_i < 1 || world < 2 || world > shmem::RING_MAX_WORLD || me < 0 ||
      me >= world || jitter < 0 || n_i > shmem::MAX_SPANS || !entry_table || !entry_mine ||
      !in_mine || !in_peer || !in_count || !out_mine || !out_peer || !out_count)
    return false;
  r.n_o = n_o;
  r.n_i = n_i;
  r.world = world;
  r.me = me;
  r.me_o = me / n_i;
  r.me_i = me % n_i;
  r.entry_table = static_cast<const long long*>(entry_table);
  r.entry_mine = static_cast<const int*>(entry_mine);
  r.in = {static_cast<int*>(in_mine), static_cast<int*>(in_peer), static_cast<int*>(in_count),
          epoch};
  r.out = {static_cast<int*>(out_mine), static_cast<int*>(out_peer),
           static_cast<int*>(out_count), epoch};
  r.w.diag = static_cast<int*>(diag);
  r.w.timeout_ns = timeout_ns;
  r.w.rank = me;
  r.w.family = family;
  r.jitter = jitter;
  return true;
}

}  // namespace

// K36. x [m rows of row_bytes], out [n_o * n_i * m rows]; ws_* the gather
// workspaces; the flags as make_ring_2d's (entry_table: this rank's copy of
// the entry set's peer table).
extern "C" int tdt_ring_all_gather_2d(const void* x, void* out, void* ws_me, void* ws_right,
                                      void* ws_down, long long row_bytes, int m, int n_o,
                                      int n_i, int me, void* entry_table, void* entry_mine,
                                      void* in_mine, void* in_peer, void* in_count,
                                      void* out_mine, void* out_peer, void* out_count,
                                      int epoch, int max_blocks, int jitter, void* diag,
                                      long long timeout_ns, int family, void* stream) {
  Ring2D r;
  if (!make_ring_2d(n_o, n_i, me, epoch, entry_table, entry_mine, in_mine, in_peer, in_count,
                    out_mine, out_peer, out_count, jitter, diag, timeout_ns, family, r) ||
      row_bytes < 1 || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long shard = row_bytes * m;
  const long long items = r.world * ((shard + GATHER_PIECE - 1) / GATHER_PIECE);
  ring_all_gather_2d_kernel<<<persistent_grid(items, max_blocks), 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out),
      static_cast<const unsigned char*>(ws_me), static_cast<unsigned char*>(ws_right),
      static_cast<unsigned char*>(ws_down), shard, r);
  return static_cast<int>(cudaGetLastError());
}

// K37. a [m_loc, k], b [k, n], out [n_o * n_i * m_loc, n]; ws_* the gather
// workspaces [n_o * n_i * m_loc, k]; flags as K36's.
extern "C" int tdt_ring_ag_gemm_2d(const void* a, const void* b, void* out, void* ws_me,
                                   void* ws_right, void* ws_down, int m_loc, int n, int k,
                                   int in_dtype, int out_dtype, int n_o, int n_i, int me,
                                   void* entry_table, void* entry_mine, void* in_mine,
                                   void* in_peer, void* in_count, void* out_mine, void* out_peer,
                                   void* out_count, int epoch, int max_blocks, int jitter,
                                   void* diag, long long timeout_ns, int family, void* stream) {
  Ring2D r;
  if (!make_ring_2d(n_o, n_i, me, epoch, entry_table, entry_mine, in_mine, in_peer, in_count,
                    out_mine, out_peer, out_count, jitter, diag, timeout_ns, family, r) ||
      m_loc < 1 || n < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch_dtypes(in_dtype, out_dtype, [&](auto e, auto t) {
    using E = decltype(e);
    using TOut = decltype(t);
    const int vec = in_dtype == kBF16 ? (bf16_vec_ok(a, b, n, k) && bf16_vec_ok(ws_me, b, n, k))
                                      : 0;
    if (E::SMEM_BYTES > 0) {
      cudaError_t attr = cudaFuncSetAttribute(ring_ag_gemm_2d_kernel<E, TOut>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              E::SMEM_BYTES);
      if (attr != cudaSuccess) return attr;
    }
    ring_ag_gemm_2d_kernel<E, TOut>
        <<<persistent_grid((long long)cdiv(m_loc, E::BM) * cdiv(n, E::BN) * r.world + r.world,
                           max_blocks),
           E::THREADS, E::SMEM_BYTES, s>>>(
            static_cast<const typename E::TIn*>(a), static_cast<const typename E::TIn*>(b),
            static_cast<TOut*>(out), static_cast<typename E::TIn*>(ws_me),
            static_cast<typename E::TIn*>(ws_right), static_cast<typename E::TIn*>(ws_down),
            m_loc, n, k, vec, r);
    return cudaSuccess;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K15. spans: host int32[2 * n_spans] of (offset, rows) covering m_loc.
extern "C" int tdt_ring_ag_gemm(const void* a, const void* b, void* out, void* ws_me,
                                void* ws_right, int m_loc, int n, int k, int in_dtype,
                                int out_dtype, const int* spans, int n_spans, int world, int me,
                                void* entry_wait, void* entry_signal, void* flags_me,
                                void* flags_right, void* count, int epoch, int max_blocks,
                                int jitter, void* diag, long long timeout_ns, int family,
                                void* stream) {
  Ring r;
  Spans sp;
  if (!make_ring(world, me, epoch, entry_wait, entry_signal, flags_me, flags_right, count,
                 jitter, diag, timeout_ns, family, r) ||
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
                                int jitter, void* diag, long long timeout_ns, int family,
                                void* stream) {
  Ring r;
  Spans sp;
  if (!make_ring(world, me, epoch, entry_wait, entry_signal, flags_me, flags_right, count,
                 jitter, diag, timeout_ns, family, r) ||
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

// K18 (one span) and K23. x [world * m_loc, n], out [m_loc, n], recv_*
// [world - 1, m_loc, n], one type; spans as K15's, covering m_loc.
extern "C" int tdt_ring_reduce_scatter(const void* x, void* out, void* recv_me,
                                       void* recv_right, int m_loc, long long n, int dtype,
                                       const int* spans, int n_spans, int world, int me,
                                       void* entry_wait, void* entry_signal, void* flags_me,
                                       void* flags_right, void* count, int epoch,
                                       int max_blocks, int jitter, void* diag,
                                       long long timeout_ns, int family, void* stream) {
  Ring r;
  Spans sp;
  if (!make_ring(world, me, epoch, entry_wait, entry_signal, flags_me, flags_right, count,
                 jitter, diag, timeout_ns, family, r) ||
      !make_spans(spans, n_spans, m_loc, sp) || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch_one(dtype, [&](auto t) {
    using T = decltype(t);
    long long items = 0;
    for (int j = 0; j < n_spans; ++j) items += (sp.rows[j] * n + PIECE_ELEMS - 1) / PIECE_ELEMS;
    ring_reduce_scatter_kernel<T><<<persistent_grid(world * items, max_blocks), 256, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), static_cast<const T*>(recv_me),
        static_cast<T*>(recv_right), m_loc, n, sp, r);
    return cudaSuccess;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K19-K22. x [m rows of row_bytes], out [world * m rows], ws_* the gather
// workspaces [world * m rows]; dirs 1 (one-way) or 2 (bidirectional: the
// *_left arguments are the left-moving half, null at dirs 1); spans as
// K15's, covering m.
extern "C" int tdt_ring_all_gather(const void* x, void* out, void* ws_me, void* ws_right,
                                   void* ws_left, long long row_bytes, int m, const int* spans,
                                   int n_spans, int dirs, int world, int me, void* entry_wait,
                                   void* entry_signal, void* flags_me, void* flags_right,
                                   void* count, void* entry_wait_left, void* entry_signal_right,
                                   void* flags_me_left, void* flags_left, void* count_left,
                                   int epoch, int max_blocks, int jitter, void* diag,
                                   long long timeout_ns, int family, void* stream) {
  Ring r;
  Spans sp;
  if (!make_ring(world, me, epoch, entry_wait, entry_signal, flags_me, flags_right, count,
                 jitter, diag, timeout_ns, family, r) ||
      !make_spans(spans, n_spans, m, sp) || row_bytes < 1 || (dirs != 1 && dirs != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  RingLeft rl = {};
  if (dirs == 2) {
    if (!entry_wait_left || !entry_signal_right || !flags_me_left || !flags_left ||
        !count_left || !ws_left)
      return static_cast<int>(cudaErrorInvalidValue);
    rl.entry_wait = static_cast<const int*>(entry_wait_left);
    rl.entry_signal = static_cast<int*>(entry_signal_right);
    rl.f.mine = static_cast<int*>(flags_me_left);
    rl.f.peer = static_cast<int*>(flags_left);
    rl.f.count = static_cast<int*>(count_left);
    rl.f.epoch = epoch;
  }
  long long per_dir = 0;
  for (int j = 0; j < n_spans; ++j)
    per_dir += (sp.rows[j] * row_bytes + GATHER_PIECE - 1) / GATHER_PIECE;
  ring_all_gather_kernel<<<persistent_grid(world * per_dir, max_blocks), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out),
      static_cast<const unsigned char*>(ws_me), static_cast<unsigned char*>(ws_right),
      static_cast<unsigned char*>(ws_left), row_bytes, sp, m, dirs, r, rl);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
