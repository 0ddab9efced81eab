// The ring kernels of the tensor-parallel path: each rank talks to its two
// neighbours only, as on a box whose ranks do not form a full mesh.
//
//   K15 tdt_ring_ag_gemm(_sm90)   ≙ ops/allgather_gemm.py:109
//                                   _ag_gemm_chunked_kernel (and, with one
//                                   span, the ring schedule of :69
//                                   _ag_gemm_kernel)
//   K16 tdt_ring_gemm_rs(_sm90)   ≙ ops/gemm_reduce_scatter.py:147
//       (one span)                  _gemm_rs_ring_kernel
//   K17 tdt_ring_gemm_rs(_sm90)   ≙ ops/gemm_reduce_scatter.py:187
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
// What bounds them on the H100. K15-K17 are K1's product with waits between
// a ring step's tiles: tensor-core throughput at prefill shapes, which
// mma.sync tiles cannot reach. bf16 that TMA can load (k and n multiples of
// 8, 16-byte aligned operands, outputs and landing buffers; the host's
// ops/common.py ring_gemm_plan) therefore runs K1's warp-specialised wgmma
// + TMA mainloop (gemm_sm90.cuh) over the ring's step walk:
// ring_ag_gemm_sm90_kernel and ring_gemm_rs_sm90_kernel below. Other bf16
// keeps K1's mma.sync tile loop (gemm_core.cuh Bf16Engine), f32 its FMA
// loop, and K37 the mma.sync tiles too. K18/K23 stream bytes: each rank reads its n chunks once, the
// landed partials once, and writes n-1 hops plus its own chunk. K19-K22
// stream bytes too: each rank reads every shard once (its own from x, the
// others from its workspace as they land) and writes it once into out and,
// unless the shard ends its trip here, once into a neighbour's workspace.
//
// The design. A ring step waits on the left neighbour's previous step, so
// the waits sit inside the kernel that issues the puts: one persistent
// kernel per rank per call, of at most floor(SMs / ranks) - 2 blocks (the
// caller's cap), so every rank's blocks are resident together. The wgmma
// kernels hold one block an SM (384 threads, 197,696 bytes of dynamic
// shared memory for the stages of either tile), so at world 4 the ranks' 4 x 31 blocks take 124 of the
// 132 SMs and every block of every rank starts: none waits for an SM that
// a spinning block holds. Its work is
// one list of items in (step, chunk) order, dealt to the blocks
// round-robin: K15 a chunk's forward pieces then its GEMM tiles, K16/K17 a
// chunk's tiles, K18/K23 a span's element pieces, K19-K22 a span's byte
// pieces (the bidirectional ring lists a step's right-moving spans, then
// its left-moving ones). An item of step s > 0 first waits (bounded,
// shmem.cuh wait_chunk) for the sending neighbour's chunk of step s-1,
// which sits earlier in that neighbour's list, so by induction over the
// steps every wait is met. The wgmma kernels keep that order and those
// waits but move them: K15's tiles are the list's GEMM items in the same
// order, its forward pieces leave the list for the producer warpgroup's
// three idle warps (so a block never stops its products to copy), and its
// producer thread, not the whole block, waits before a landed span's first
// load; K16/K17 wait for the left partial only before the epilogue that
// adds it, after the tile's k loop, which reads only this rank's own a and
// b (see the kernels' notes below). Every store towards the
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
#include "gemm_sm90.cuh"
#include "shmem.cuh"

#include <initializer_list>

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

// --------------------------------------------- K15, K16/K17 on wgmma + TMA ----
// bf16 K15 and K16/K17 on K1's warp-specialised mainloop (gemm_sm90.cuh
// gemm_sm90_body), on a persistent grid of at most floor(SMs / ranks) - 2
// blocks (the host's plan). The ring protocol is the mma.sync kernels':
// Ring::enter first on every block (before the role split, so no side warp
// and no epilogue stores into the right neighbour before its arrival), the
// same step order, one flag per (step, span), every landing slot written
// once per call, and the same wait sites.
//
// The walks go step-major, steps s = 0 .. n-1. K16/K17 (ring_tile): then
// the spans j in order, then K1's grouped raster over the span's [rows_j,
// n] output. K15 (ring_step_tile): then K1's grouped raster over all of the
// step's row tiles, the spans' tiles in order, so a B panel serves every
// row tile of the step and not only a span's (with two 256-row spans a
// shard the per-span raster re-read each B panel once per span: the 70B
// column projections' kernel took 23.7 ms against 17.6 at one span, the
// step raster 17.7 at two: chip_phases.py ag_gemm_ring on an H100 80GB
// HBM3 at 700 W). A row
// tile counts from its span's offset, and no row at or past the span's end
// is stored. A 128-row A box at a span's last row tile may read rows of the
// next span (K15: rows that may not have landed yet); those output rows are
// masked on store, so what they held changes nothing.

constexpr int RING_BM = 128;  // the row tile of both configs (two consumer warpgroups)

__device__ __forceinline__ int span_tiles(const Spans& sp, int j) {
  return cdiv(sp.rows[j], RING_BM);
}

// tile t of a step walk of `per_step` tiles a step, nt column tiles
__device__ __forceinline__ sm90::Coord ring_tile(const Spans& sp, int nt, int per_step, int t) {
  sm90::Coord x;
  x.step = t / per_step;
  int rest = t - x.step * per_step, j = 0;
  for (; j < sp.n - 1; ++j) {
    const int tj = span_tiles(sp, j) * nt;
    if (rest < tj) break;
    rest -= tj;
  }
  sm90::tile_coords(rest, span_tiles(sp, j), nt, x.tm, x.tn);
  x.span = j;
  x.off = sp.off[j];
  x.end = sp.off[j] + sp.rows[j];
  return x;
}

// row tile r of a step's row tiles (the spans' tiles in order) into x
__device__ __forceinline__ void span_of(const Spans& sp, int r, sm90::Coord& x) {
  int j = 0;
  while (j < sp.n - 1 && r >= span_tiles(sp, j)) r -= span_tiles(sp, j++);
  x.tm = r;
  x.span = j;
  x.off = sp.off[j];
  x.end = sp.off[j] + sp.rows[j];
}

// tile t of K15's step walk: one grouped raster over the step's row tiles
__device__ __forceinline__ sm90::Coord ring_step_tile(const Spans& sp, int nt, int per_step,
                                                      int t) {
  sm90::Coord x;
  x.step = t / per_step;
  int r;
  sm90::tile_coords(t - x.step * per_step, per_step / nt, nt, r, x.tn);
  span_of(sp, r, x);
  return x;
}

__device__ __forceinline__ int ring_per_step(const Spans& sp, int nt) {
  int per_step = 0;
  for (int j = 0; j < sp.n; ++j) per_step += span_tiles(sp, j) * nt;
  return per_step;
}

// `bytes` (a multiple of 16, every end 16-byte aligned) from src into d0
// and, unless null, d1, by `nth` threads, four 16-byte loads in flight a
// thread
__device__ __forceinline__ void copy16_2(unsigned char* d0, unsigned char* d1,
                                         const unsigned char* src, long long bytes, int tid,
                                         int nth) {
  uint4* a = reinterpret_cast<uint4*>(d0);
  uint4* b = reinterpret_cast<uint4*>(d1);
  const uint4* s = reinterpret_cast<const uint4*>(src);
  const long long n16 = bytes / 16;
  long long i = tid;
  for (; i + 3LL * nth < n16; i += 4LL * nth) {
    const uint4 v0 = s[i], v1 = s[i + nth], v2 = s[i + 2 * nth], v3 = s[i + 3 * nth];
    a[i] = v0;
    a[i + nth] = v1;
    a[i + 2 * nth] = v2;
    a[i + 3 * nth] = v3;
    if (b) {
      b[i] = v0;
      b[i + nth] = v1;
      b[i + 2 * nth] = v2;
      b[i + 3 * nth] = v3;
    }
  }
  for (; i < n16; i += nth) {
    const uint4 v = s[i];
    a[i] = v;
    if (b) b[i] = v;
  }
}

// K15. Tile (s, j) multiplies span j of shard c = me - s: step 0 from this
// rank's a (a 3-D map [1, m_loc, k]), steps s >= 1 from slab c of the
// gather workspace (a 3-D map [world, m_loc, k], so a box never reads into
// the next shard), and stores into out + c * m_loc * n. Before its first
// load of (s >= 1, j) the producer thread waits (bounded: Ring::
// wait_landed_thread, the mma.sync kernel's site) for the left neighbour's
// span, then issues the global proxy fence (its forwards were generic
// stores, TMA reads them); a wait that expired aborts the block (the body's
// abort word). The forwards (step s < n-1, span j: the span's bytes into
// the right neighbour's workspace, and at step 0 into this rank's own) are
// not tiles: the producer warpgroup's three idle warps carry them
// (side_work), the (s, j) pieces dealt over the grid in step order, each
// block its share; before a landed span's first piece they make the same
// bounded wait, and the piece count raises the right neighbour's (s, j)
// flag. They depend on no product, so they run ahead of the tiles and a
// put never waits on a GEMM.
struct RingAgWalk : sm90::WalkBase {
  static constexpr bool SLABS = true, CAN_ABORT = true, SIDE_WORK = true;
  int nt, per_step;
  const Spans* sp;
  Ring r;
  const CUtensorMap* map_own;  // this rank's a as [1, m_loc, k]
  const CUtensorMap* map_ws;   // the gather workspace as [world, m_loc, k]
  const bf16* a;
  bf16* ws_me;
  bf16* ws_right;
  int m_loc, k;
  int waited;  // the (step, span) slot this block's producer last met

  __device__ __forceinline__ int shard(int step) const {
    return (r.me - step + r.world) % r.world;
  }
  __device__ __forceinline__ int tiles() const { return r.world * per_step; }
  __device__ __forceinline__ sm90::Coord at(int t) const {
    sm90::Coord x = ring_step_tile(*sp, nt, per_step, t);
    x.slab = x.step == 0 ? 0 : shard(x.step);
    return x;
  }
  __device__ __forceinline__ bool ready(const sm90::Coord& x) {
    // a step's spans interleave in the raster: a flag already met is met
    // again at once (flags only rise)
    const int key = ChunkFlags::slot(x.step, x.span);
    if (x.step == 0 || key == waited) return true;
    waited = key;
    const bool ok = r.wait_landed_thread(x.step, x.span);
    sm90::fence_proxy_async_global();
    return ok;
  }
  __device__ __forceinline__ const CUtensorMap* a_map(const sm90::Coord& x,
                                                      const CUtensorMap*) const {
    return x.step == 0 ? map_own : map_ws;
  }
  template <typename TOut>
  __device__ __forceinline__ TOut* out(TOut* c, const sm90::Coord& x, int m, int n) const {
    return c + static_cast<size_t>(shard(x.step)) * m * n;
  }
  __device__ __forceinline__ void side_work(int tid, int nth) const {
    const Spans& s_ = *sp;
    int first = 0;  // the (s, j) pieces' first index in the grid-wide deal
    for (int s = 0; s < r.world - 1; ++s) {
      const int c = shard(s);
      for (int j = 0; j < s_.n; ++j) {
        const long long bytes = static_cast<long long>(s_.rows[j]) * k * sizeof(bf16);
        const int pieces = static_cast<int>((bytes + PIECE_BYTES - 1) / PIECE_BYTES);
        const size_t at = (static_cast<size_t>(c) * m_loc + s_.off[j]) * k * sizeof(bf16);
        const unsigned char* src =
            s == 0 ? reinterpret_cast<const unsigned char*>(a + static_cast<size_t>(s_.off[j]) * k)
                   : reinterpret_cast<const unsigned char*>(ws_me) + at;
        unsigned char* own = s == 0 ? reinterpret_cast<unsigned char*>(ws_me) + at : nullptr;
        unsigned char* right = reinterpret_cast<unsigned char*>(ws_right) + at;
        const int grid = gridDim.x;
        int p = first + ((static_cast<int>(blockIdx.x) - first) % grid + grid) % grid;
        bool met = s == 0;
        for (; p < first + pieces; p += grid) {
          if (!met) {  // the left neighbour's span has landed here
            if (tid == 0) {
              r.wait_landed_thread(s, j);
              __threadfence();
            }
            sm90::named_barrier(sm90::SIDE_BAR, nth);
            met = true;
          }
          const long long lo = static_cast<long long>(p - first) * PIECE_BYTES;
          const long long len = min(PIECE_BYTES, bytes - lo);
          copy16_2(right + lo, own ? own + lo : nullptr, src + lo, len, tid, nth);
          shmem::chunk_piece_done_group(r.f, s, j, pieces, sm90::SIDE_BAR, nth, tid == 0);
        }
        first += pieces;
      }
    }
  }
};

template <int BN, int STAGES, typename TOut>
__global__ void __launch_bounds__(sm90::Tile<2, BN, STAGES>::THREADS, 1)
    ring_ag_gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_own,
                             const __grid_constant__ CUtensorMap map_ws,
                             const __grid_constant__ CUtensorMap map_b, const bf16* a,
                             TOut* __restrict__ out, bf16* ws_me, bf16* ws_right, int m_loc,
                             int n, int k, const __grid_constant__ Spans sp, Ring r) {
  shmem::comm_jitter(r.me, 8, r.jitter, r.world);
  r.enter();
  const int nt = cdiv(n, BN);
  const RingAgWalk walk{{},    nt,    ring_per_step(sp, nt), &sp,   r,     &map_own, &map_ws,
                        a,     ws_me, ws_right,              m_loc, k,     -1};
  sm90::gemm_sm90_body<2, BN, STAGES, TOut, false>(map_ws, map_b, out, m_loc, n, k,
                                                   AddList<TOut>{}, walk);
}

// K16/K17. Tile (s, j) multiplies span j of this rank's row chunk c = me -
// 1 - s (a 3-D map [world, m_loc, k] over a: no wait before any load, since
// the k loop reads only this rank's own a and b). Its epilogue (s > 0)
// first waits, once per (s, j) and block (one consumer thread's bounded
// wait at the mma.sync kernel's site, then the consumers' named barrier),
// for the left neighbour's partial of span j, step s-1; it then adds the
// landed slot s-1 in f32 and rounds once to the output type (the hop's
// rounding of gemm_add_pipeline), and stores into the right neighbour's
// landing slot s through the peer pointer (the last step into out). The
// stored tiles of (s, j) are counted as pieces; the block that stores the
// last raises the right neighbour's (s, j) flag, ordered after every
// block's stores (each thread's system fence, the consumers' barrier, the
// count's atomic, a fence, the release store). So a step's products run
// while its left partial is still in flight: the producer keeps loading
// while the consumers wait in an epilogue, but no further than STAGES k
// steps of the next tile ahead (it waits on the stages' "empty" barriers),
// and the next tile's products start once the wait is met. An epilogue wait
// that expired makes the block skip that store and every later product and
// store, draining the stages; it still raises its tiles' flags, as the
// mma.sync kernel goes on after an expired wait.
template <typename TOut>
struct RingRsWalk : sm90::WalkBase {
  static constexpr bool SLABS = true, CAN_ABORT = true, SIGNALS = true, EPI_WAIT = true;
  int nt, per_step;
  const Spans* sp;
  Ring r;
  const TOut* recv_me;  // this rank's landing slots [world - 1, m_loc, n]
  TOut* recv_right;     // the right neighbour's
  int m_loc, n;
  int waited;  // the (step, span) slot whose partial this block's consumers last met
  int flip;    // which of the two result words the next wait writes

  __device__ __forceinline__ int tiles() const { return r.world * per_step; }
  __device__ __forceinline__ sm90::Coord at(int t) const {
    sm90::Coord x = ring_tile(*sp, nt, per_step, t);
    x.slab = (r.me - 1 - x.step + 2 * r.world) % r.world;
    return x;
  }
  __device__ __forceinline__ TOut* out(TOut* c, const sm90::Coord& x, int m, int n_) const {
    return x.step == r.world - 1 ? c : recv_right + static_cast<size_t>(x.step) * m * n_;
  }
  __device__ __forceinline__ AddList<TOut> adds(const sm90::Coord& x,
                                                const AddList<TOut>&) const {
    AddList<TOut> l = {};
    if (x.step > 0) {
      l.n = 1;
      l.p[0] = recv_me + static_cast<size_t>(x.step - 1) * m_loc * n;
    }
    return l;
  }
  __device__ __forceinline__ bool landed(const sm90::Coord& x) {
    const int key = ChunkFlags::slot(x.step, x.span);
    if (x.step == 0 || key == waited) return true;  // flags only rise
    waited = key;
    // two words, used in turn: a thread still to read the last wait's word
    // cannot be overtaken by the one after it (a barrier lies between)
    __shared__ int ok_s[2];
    flip ^= 1;
    if (threadIdx.x == 128) {
      const bool ok = r.wait_landed_thread(x.step, x.span);
      __threadfence();
      ok_s[flip] = ok;
    }
    sm90::consumers_sync<2>();
    return ok_s[flip] != 0;
  }
  __device__ __forceinline__ void stored(const sm90::Coord& x) const {
    if (x.step == r.world - 1) return;  // the last step stores into out: no signal
    shmem::chunk_piece_done_group(r.f, x.step, x.span, span_tiles(*sp, x.span) * nt, 1, 256,
                                  threadIdx.x == 128);
  }
};

template <int BN, int STAGES, typename TOut>
__global__ void __launch_bounds__(sm90::Tile<2, BN, STAGES>::THREADS, 1)
    ring_gemm_rs_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                             const __grid_constant__ CUtensorMap map_b, TOut* __restrict__ out,
                             const TOut* recv_me, TOut* recv_right, int m_loc, int n, int k,
                             const __grid_constant__ Spans sp, Ring r) {
  shmem::comm_jitter(r.me, 11, r.jitter, r.world);
  r.enter();
  const int nt = cdiv(n, BN);
  const RingRsWalk<TOut> walk{{}, nt, ring_per_step(sp, nt), &sp, r, recv_me, recv_right,
                              m_loc, n, -1, 0};
  sm90::gemm_sm90_body<2, BN, STAGES, TOut, true>(map_a, map_b, out, m_loc, n, k,
                                                  AddList<TOut>{}, walk);
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

namespace {

// the operands the wgmma + TMA ring kernels take: bf16 with 16-byte rows (k
// and n multiples of 8) and 16-byte aligned bases (the host routes others
// to tdt_ring_ag_gemm / tdt_ring_gemm_rs)
bool ring_sm90_ok(std::initializer_list<const void*> ptrs, int n, int k, int config, int grid) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return bits % 16 == 0 && n >= 1 && k >= 1 && n % 8 == 0 && k % 8 == 0 && config >= 0 &&
         config <= 1 && grid >= 1;
}

// a bf16 [slabs, m, k] row-major operand as a 3-D map of 128-row boxes
cudaError_t slab_map(CUtensorMap* map, const void* base, int slabs, int m, int k) {
  const long long dims[3] = {k, m, slabs}, strides[2] = {2LL * k, 2LL * k * m};
  const long long box[3] = {sm90::BK, RING_BM, 1};
  return sm90::make_map_nd(map, base, 3, dims, strides, box);
}

// b [k, n] row-major as a 2-D map of [64 k][64 n] boxes
cudaError_t b_map(CUtensorMap* map, const void* b, int n, int k) {
  const long long dims[2] = {n, k}, box[2] = {sm90::BOX_N, sm90::BK};
  return sm90::make_map(map, b, dims, 2LL * n, box);
}

}  // namespace

// K15 on the wgmma + TMA engine (ring_ag_gemm_sm90_kernel): bf16 a [m_loc,
// k], b [k, n], out [world * m_loc, n] in out_dtype, the gather workspaces
// as tdt_ring_ag_gemm's; k and n multiples of 8, every pointer 16-byte
// aligned. config K1's tile (0: 128x256, 1: 128x128), grid the persistent
// block count (<= the co-residency cap); the rest as tdt_ring_ag_gemm's.
extern "C" int tdt_ring_ag_gemm_sm90(const void* a, const void* b, void* out, void* ws_me,
                                     void* ws_right, int m_loc, int n, int k, int out_dtype,
                                     const int* spans, int n_spans, int world, int me,
                                     void* entry_wait, void* entry_signal, void* flags_me,
                                     void* flags_right, void* count, int epoch, int config,
                                     int grid, int jitter, void* diag, long long timeout_ns,
                                     int family, void* stream) {
  Ring r;
  Spans sp;
  if (!make_ring(world, me, epoch, entry_wait, entry_signal, flags_me, flags_right, count,
                 jitter, diag, timeout_ns, family, r) ||
      !make_spans(spans, n_spans, m_loc, sp) ||
      !ring_sm90_ok({a, b, out, ws_me, ws_right}, n, k, config, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m_own, m_ws, m_b;
  cudaError_t err = slab_map(&m_own, a, 1, m_loc, k);
  if (err == cudaSuccess) err = slab_map(&m_ws, ws_me, world, m_loc, k);
  if (err == cudaSuccess) err = b_map(&m_b, b, n, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dispatch_one(out_dtype, [&](auto t) {
    using TOut = decltype(t);
    return sm90::with_config(config, [&](auto bn, auto stages) -> cudaError_t {
      constexpr int BN = decltype(bn)::value, STAGES = decltype(stages)::value;
      using T = sm90::Tile<2, BN, STAGES>;
      auto kernel = ring_ag_gemm_sm90_kernel<BN, STAGES, TOut>;
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(T::SMEM_BYTES));
      if (e != cudaSuccess) return e;
      kernel<<<grid, T::THREADS, T::SMEM_BYTES, s>>>(
          m_own, m_ws, m_b, static_cast<const bf16*>(a), static_cast<TOut*>(out),
          static_cast<bf16*>(ws_me), static_cast<bf16*>(ws_right), m_loc, n, k, sp, r);
      return cudaSuccess;
    });
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K16 (one span) and K17 on the wgmma + TMA engine
// (ring_gemm_rs_sm90_kernel): bf16 a [world * m_loc, k], b [k, n], out
// [m_loc, n] and the landing slots [world - 1, m_loc, n] in out_dtype; k
// and n multiples of 8, every pointer 16-byte aligned; config and grid as
// tdt_ring_ag_gemm_sm90's, the rest as tdt_ring_gemm_rs's.
extern "C" int tdt_ring_gemm_rs_sm90(const void* a, const void* b, void* out, void* recv_me,
                                     void* recv_right, int m_loc, int n, int k, int out_dtype,
                                     const int* spans, int n_spans, int world, int me,
                                     void* entry_wait, void* entry_signal, void* flags_me,
                                     void* flags_right, void* count, int epoch, int config,
                                     int grid, int jitter, void* diag, long long timeout_ns,
                                     int family, void* stream) {
  Ring r;
  Spans sp;
  if (!make_ring(world, me, epoch, entry_wait, entry_signal, flags_me, flags_right, count,
                 jitter, diag, timeout_ns, family, r) ||
      !make_spans(spans, n_spans, m_loc, sp) ||
      !ring_sm90_ok({a, b, out, recv_me, recv_right}, n, k, config, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m_a, m_b;
  cudaError_t err = slab_map(&m_a, a, world, m_loc, k);
  if (err == cudaSuccess) err = b_map(&m_b, b, n, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dispatch_one(out_dtype, [&](auto t) {
    using TOut = decltype(t);
    return sm90::with_config(config, [&](auto bn, auto stages) -> cudaError_t {
      constexpr int BN = decltype(bn)::value, STAGES = decltype(stages)::value;
      using T = sm90::Tile<2, BN, STAGES>;
      auto kernel = ring_gemm_rs_sm90_kernel<BN, STAGES, TOut>;
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(T::SMEM_BYTES));
      if (e != cudaSuccess) return e;
      kernel<<<grid, T::THREADS, T::SMEM_BYTES, s>>>(
          m_a, m_b, static_cast<TOut*>(out), static_cast<const TOut*>(recv_me),
          static_cast<TOut*>(recv_right), m_loc, n, k, sp, r);
      return cudaSuccess;
    });
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
