// The padded-slab all-to-all of expert-parallel MoE dispatch and combine,
// all ranks of one process (parallel/mesh.py) on one card or on
// peer-accessible cards:
//
//   K27 tdt_all_to_all_{push,collect}   ≙ ops/all_to_all.py:92 _a2a_kernel
//       (one span a slab)                  (launched through
//                                          _fast_all_to_all_fused, :233)
//   K28 the same, spans                 ≙ ops/all_to_all.py:136
//                                          _a2a_chunked_kernel, with
//                                          shmem/device.py:373
//                                          putmem_signal_chunked_a2a_nbi_block
//                                          (shmem.cuh putmem_signal_chunked_a2a_block)
//
// What they compute. Every rank holds a send buffer [world, max_m, row] of
// padded slabs and an int32 payload [world, w] (the slab's valid count,
// then per-slab metadata: expert ids, and with a one-byte wire the bitcast
// f32 row scales). Slab d of rank me lands as slab me of rank d's recv, and
// payload row d as row me of rank d's payload; the own slab and row are a
// local copy. Full slabs always move, whatever the counts say (the TPU
// kernel's contract: the receiver's padding rows are the sender's zeros).
// K28 moves each slab as len(spans) chunks with a flag slot per (sender,
// chunk), issued and consumed chunk-major: every peer's chunk j before any
// chunk j+1. The payload rides chunk 0.
//
// What bounds them on the H100. Bytes: every slab is read once and written
// once (at the receiver's end), plus this port's one landing copy (see
// below). At the EP prefill shape a rank moves 4 x 1024 x 4096 bf16 = 32
// MiB; at decode 4 x 4 x 4096 = 128 KiB, where the launches and the host
// rendezvous are the time.
//
// The design. A call is two launches on the rank's stream with one host
// rendezvous between them (parallel/mesh.py), so no device wait is issued
// before what it waits for:
//
// - push: the blocks put this rank's slab pieces straight into every
//   peer's symmetric workspace, slot me, in chunk-major order, and the
//   block that lands a chunk's last piece raises the peer's (me, chunk)
//   flag to the launch's epoch (chunk_piece_done's counting); the own slab
//   is copied into recv[me]. No block spins, so the grid needs no cap.
// - collect: a persistent grid of at most floor(SMs / ranks) - 2 blocks
//   walks the (chunk, peer, piece) items chunk-major, waits (bounded) on
//   the item's flag — on the sender's chunk 0 first, so a sender that
//   never comes is always named by that site — and copies the landed piece
//   out of the workspace into the private recv. Sites: world + sender *
//   MAX_SPANS + chunk (resilience/sites.py).
//
// Reuse without an entry barrier: the workspace holds two regions and a
// launch of epoch e lands in region e % 2. A peer's push of call e into
// region e % 2 of this rank comes after that peer's collect of call e-1,
// which waited for this rank's push of call e-1, which this rank's stream
// ran after its collect of call e-2, the last reader of the region. So the
// TPU kernel's opening barrier_all (:108) is replaced by the double buffer
// the reference keeps (low_latency_all_to_all.py:36-118, call_count), and a
// peer that never comes is named at its data site, not at a barrier. The
// returned recv is private: the next call overwrites only the workspace.
//
// The push starts with the race-shaking delay (shmem.cuh comm_jitter, the
// JAX kernels' salt 5), a no-op unless the launch asks for it.

#include "shmem.cuh"

namespace {

using shmem::MAX_SPANS;
using shmem::Spans;
using shmem::WaitCtx;

constexpr int MAX_WORLD = 8;
constexpr int MAX_PIECES = 64;

// One launch's buffers: this rank's send slabs and payload, its private
// recv and payload out, the workspace's peer table with this launch's
// region (offset by epoch parity) and the payload's offset in a region.
struct Exchange {
  const unsigned char* send;  // [world, max_m * row_bytes]
  const int* payload;         // [world, w]
  unsigned char* recv;        // [world, max_m * row_bytes]
  int* rpayload;              // [world, w]
  const long long* ws;        // peer table of the workspace
  long long region;           // this launch's region offset
  long long pay_off;          // payload slots' offset in a region
  long long row_bytes;
  long long slab_bytes;
  int w;
  int world, me, epoch;

  __device__ __forceinline__ unsigned char* landing(int rank) const {
    return shmem::peer_ptr<unsigned char>(ws, rank) + region;
  }
};

// rows [lo, lo + n) of piece `piece` of `pieces` equal pieces of `rows` rows
__device__ __forceinline__ void piece_rows(int rows, int pieces, int piece, int& lo, int& n) {
  const int per = (rows + pieces - 1) / pieces;
  lo = min(rows, piece * per);
  n = min(rows, lo + per) - lo;
}

__global__ void a2a_push_kernel(Exchange x, const long long* flags, int* count, Spans sp,
                                int pieces, int jitter) {
  shmem::comm_jitter(x.me, 5, jitter, x.world);
  const int peers = x.world - 1;
  const int remote = sp.n * peers * pieces;
  int b = blockIdx.x;
  int lo, n;
  if (b >= remote) {  // the own slab and payload row: local copies
    b -= remote;
    const int max_m = static_cast<int>(x.slab_bytes / x.row_bytes);
    piece_rows(max_m, sp.n * pieces, b, lo, n);
    const long long at = x.me * x.slab_bytes + lo * x.row_bytes;
    shmem::putmem_nbi_block(x.recv + at, x.send + at, n * x.row_bytes);
    if (b == 0)
      shmem::putmem_nbi_block(x.rpayload + x.me * x.w, x.payload + x.me * x.w, 4LL * x.w);
    return;
  }
  // chunk-major: every peer's chunk j before any chunk j + 1
  const int piece = b % pieces, item = b / pieces;
  const int j = item / peers;
  const int dst = (x.me + item % peers + 1) % x.world;
  piece_rows(sp.rows[j], pieces, piece, lo, n);
  lo += sp.off[j];
  unsigned char* land = x.landing(dst);
  if (j == 0 && piece == 0)  // the payload rides chunk 0
    shmem::putmem_nbi_block(land + x.pay_off + 4LL * x.me * x.w, x.payload + dst * x.w,
                            4LL * x.w);
  shmem::putmem_signal_chunked_a2a_block(
      land + x.me * x.slab_bytes + lo * x.row_bytes,
      x.send + dst * x.slab_bytes + lo * x.row_bytes, n * x.row_bytes, flags, count, dst, x.me,
      j, pieces, x.epoch);
}

__global__ void a2a_collect_kernel(Exchange x, const long long* flags, Spans sp, int pieces,
                                   WaitCtx w) {
  const int peers = x.world - 1;
  const int total = sp.n * peers * pieces;
  const int* mine = shmem::peer_ptr<int>(flags, x.me);
  const unsigned char* land = x.landing(x.me);
  int waited = -1;
  for (int u = blockIdx.x; u < total; u += gridDim.x) {
    const int piece = u % pieces, item = u / pieces;
    const int j = item / peers;
    const int src = (x.me - item % peers - 1 + x.world) % x.world;
    const int slot = src * MAX_SPANS + j;
    if (slot != waited) {  // flags only rise: one wait per (sender, chunk) and block
      // chunk 0 first, which the sender issues first: a sender that never
      // comes is named by its chunk-0 site, whichever block's clock runs out
      if (j > 0)
        shmem::wait_block(mine + src * MAX_SPANS, x.epoch, w, x.world + src * MAX_SPANS,
                          shmem::KIND_SIGNAL);
      shmem::wait_block(mine + slot, x.epoch, w, x.world + slot, shmem::KIND_SIGNAL);
      waited = slot;
    }
    int lo, n;
    piece_rows(sp.rows[j], pieces, piece, lo, n);
    lo += sp.off[j];
    const long long at = src * x.slab_bytes + lo * x.row_bytes;
    shmem::putmem_nbi_block(x.recv + at, land + at, n * x.row_bytes);
    if (j == 0 && piece == 0)
      shmem::putmem_nbi_block(x.rpayload + src * x.w, land + x.pay_off + 4LL * src * x.w,
                              4LL * x.w);
  }
}

bool make_spans(const int* spans, int n_spans, int max_m, Spans& sp) {
  if (n_spans < 1 || n_spans > MAX_SPANS) return false;
  int next = 0;
  sp.n = n_spans;
  for (int j = 0; j < MAX_SPANS; ++j) {
    sp.off[j] = j < n_spans ? spans[2 * j] : 0;
    sp.rows[j] = j < n_spans ? spans[2 * j + 1] : 0;
    if (j < n_spans && (sp.off[j] != next || sp.rows[j] < 1)) return false;
    if (j < n_spans) next += sp.rows[j];
  }
  return next == max_m;
}

bool make_exchange(const void* send, const void* payload, void* recv, void* rpayload,
                   long long row_bytes, int max_m, int w, const void* ws, long long region,
                   long long pay_off, int world, int me, int epoch, Exchange& x) {
  if (world < 2 || world > MAX_WORLD || me < 0 || me >= world || row_bytes < 1 || max_m < 1 ||
      w < 1 || pay_off < world * row_bytes * max_m || pay_off % 16 != 0 || region % 16 != 0)
    return false;
  x.send = static_cast<const unsigned char*>(send);
  x.payload = static_cast<const int*>(payload);
  x.recv = static_cast<unsigned char*>(recv);
  x.rpayload = static_cast<int*>(rpayload);
  x.ws = static_cast<const long long*>(ws);
  x.region = region;
  x.pay_off = pay_off;
  x.row_bytes = row_bytes;
  x.slab_bytes = row_bytes * max_m;
  x.w = w;
  x.world = world;
  x.me = me;
  x.epoch = epoch;
  return true;
}

}  // namespace

// K27 / K28, the push. send [world, max_m, row_bytes] and payload int32
// [world, w] (this rank's), recv / rpayload the same shapes (private); ws
// the workspace's device peer table, region this launch's region offset in
// every rank's workspace and pay_off the payload slots' offset inside it
// (16-byte aligned, past the world data slots); flags the device peer table
// of the int32[world * MAX_SPANS] (sender, chunk) flag sets; count this
// rank's int32[world * MAX_SPANS] piece counts (zero between launches);
// spans host int32[2 * n_spans] (offset, rows) covering max_m; pieces the
// pieces a chunk moves in (1..64).
extern "C" int tdt_all_to_all_push(const void* send, const void* payload, void* recv,
                                   void* rpayload, long long row_bytes, int max_m, int w,
                                   const void* ws, long long region, long long pay_off,
                                   const void* flags, void* count, const int* spans, int n_spans,
                                   int pieces, int world, int me, int epoch, int jitter,
                                   void* stream) {
  Exchange x;
  Spans sp;
  if (!make_exchange(send, payload, recv, rpayload, row_bytes, max_m, w, ws, region, pay_off,
                     world, me, epoch, x) ||
      !make_spans(spans, n_spans, max_m, sp) || pieces < 1 || pieces > MAX_PIECES || jitter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_spans * (world - 1) + n_spans) * pieces;
  a2a_push_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const long long*>(flags), static_cast<int*>(count), sp, pieces, jitter);
  return static_cast<int>(cudaGetLastError());
}

// K27 / K28, the collect: the push's arguments, and the persistent grid's
// cap and the bounded-wait arguments. Issued only once every rank's push
// is.
extern "C" int tdt_all_to_all_collect(void* recv, void* rpayload, long long row_bytes, int max_m,
                                      int w, const void* ws, long long region, long long pay_off,
                                      const void* flags, const int* spans, int n_spans,
                                      int pieces, int world, int me, int epoch, int max_blocks,
                                      void* diag, long long timeout_ns, int family,
                                      void* stream) {
  Exchange x;
  Spans sp;
  if (!make_exchange(nullptr, nullptr, recv, rpayload, row_bytes, max_m, w, ws, region, pay_off,
                     world, me, epoch, x) ||
      !make_spans(spans, n_spans, max_m, sp) || pieces < 1 || pieces > MAX_PIECES)
    return static_cast<int>(cudaErrorInvalidValue);
  WaitCtx wc;
  wc.diag = static_cast<int*>(diag);
  wc.timeout_ns = timeout_ns;
  wc.rank = me;
  wc.family = family;
  const int items = n_spans * (world - 1) * pieces;
  const int cap = max_blocks > 0 ? max_blocks : 1;
  a2a_collect_kernel<<<items < cap ? items : cap, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const long long*>(flags), sp, pieces, wc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
