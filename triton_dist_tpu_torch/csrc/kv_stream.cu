// The KV handoff stream of disaggregated prefill / decode: every rank
// exchanges its page slab with its mirror rank (me + world / 2) mod world,
// all ranks of one process (parallel/mesh.py) on one card or on
// peer-accessible cards:
//
//   K41 tdt_kv_stream_{push,collect},        ≙ ops/kv_stream.py:172
//       one put
//       (the native wire)                       _kv_stream_kernel
//   K42 the same, two puts                   ≙ ops/kv_stream.py:204
//       (the int8 and fp8 wires)                _kv_stream_w8_kernel
//
// What they compute. Rank me holds a slab [m, row] (any dtype: the
// protocol never reads the payload, so fp8 moves as bytes) and, on the
// one-byte wires, its f32 row scales [m, 1]. The slab moves to the mirror
// chunk by chunk over the spans of chunk_schedule(m, chunks_per_shard), and
// the mirror's slab lands at the same offsets of this rank's out. On the
// one-byte wires the scales ride a second chunked put over the same row
// spans, with flag slots of their own.
//
// What bounds them on the H100. Bytes: each rank reads its slab once and
// writes it once at the mirror, plus this port's one copy out of the
// landing buffer (below). At the full width (the KV of one Llama-3.1-8B
// prompt, m 65536 rows of 1024 bf16) a rank moves 128 MiB, 64 MiB + 256
// KiB on the one-byte wires.
//
// The design. A call is two launches on the rank's stream with one host
// rendezvous between them (parallel/mesh.py), so no device wait is issued
// before what it waits for:
//
// - push: the blocks put this rank's slab (and scales) into the mirror's
//   symmetric workspace, at the same offsets, chunk by chunk; a chunk is
//   cut into byte pieces of at most 256 KiB (16-byte multiples), one block
//   each, so a large slab rides many blocks, and the block that lands a
//   chunk's last piece raises the mirror's flag slot of that chunk to the
//   launch's epoch (shmem.cuh chunk_piece_done). No block spins, so the
//   grid needs no cap.
// - collect: a persistent grid of at most floor(SMs / ranks) - 2 blocks
//   walks the (chunk, put, piece) items chunk-major (on the one-byte wires
//   the payload chunk j before its scale chunk j), waits (bounded) on the
//   item's flag — on the payload's chunk 0 first, so a mirror that never
//   comes is always named by that site — and copies the landed piece out
//   of the workspace into the private out. Sites: world + j (payload),
//   world + MAX_SPANS + j (scales) (resilience/sites.py).
//
// The landing buffer. The result is a private tensor, so the landed slab is
// copied out of the workspace once: a second pass over the slab's bytes,
// inside the call. The workspace holds two regions and a launch of epoch e
// lands in region e % 2 (csrc/a2a.cu's discipline): the mirror's push of
// call e into region e % 2 of this rank comes after the mirror's collect
// of call e - 1, which waited for this rank's push of call e - 1, which
// this rank's stream ran after its collect of call e - 2, the last reader
// of the region. So the TPU kernel's opening barrier_all (:181) is replaced
// by the double buffer, and a mirror that never comes is named at its data
// site. Flags carry epochs (shmem.cuh): the three wires share one epoch
// counter, one flag set and one workspace, so a flag slot only ever rises.
//
// The push starts with the race-shaking delay (shmem.cuh comm_jitter, the
// JAX kernels' salts 9 and 10), a no-op unless the launch asks for it.

#include "shmem.cuh"

namespace {

using shmem::ChunkFlags;
using shmem::MAX_SPANS;
using shmem::Spans;
using shmem::WaitCtx;

constexpr int MAX_WORLD = 8;
constexpr int MAX_PIECES = 1024;

// One launch's side of the stream: this rank's slab and scales (push) or
// its private out and scale out (collect), the workspace region's offset
// of the scales, the bytes of a payload row and the pieces a chunk of the
// slab / the scales moves in.
struct Stream {
  const unsigned char* src;   // push: the slab; collect: unused
  const unsigned char* s_src;
  unsigned char* out;         // collect: the private out; push: unused
  unsigned char* s_out;
  const long long* ws;        // the workspace's peer table
  long long region;           // this launch's region offset
  long long s_off;            // the scales' offset inside a region
  long long row_bytes;
  int pieces, s_pieces, n_puts;
  int world, me, epoch;

  __device__ __forceinline__ int mirror() const { return (me + world / 2) % world; }
  __device__ __forceinline__ int items(const Spans& sp) const {
    return sp.n * (pieces + (n_puts == 2 ? s_pieces : 0));
  }
  // item u, chunk-major: chunk j's payload pieces, then its scale pieces
  __device__ __forceinline__ void item(int u, int& put, int& j, int& piece) const {
    const int per = pieces + (n_puts == 2 ? s_pieces : 0);
    j = u / per;
    piece = u % per;
    put = piece < pieces ? 0 : 1;
    if (put) piece -= pieces;
  }
  // bytes [lo, hi) of the item, from the start of a region
  __device__ __forceinline__ void bytes(const Spans& sp, int put, int j, int piece,
                                        long long& lo, long long& hi) const {
    const long long rb = put ? 4 : row_bytes;
    const int n = put ? s_pieces : pieces;
    const long long chunk = sp.rows[j] * rb;
    const long long per = ((chunk + n - 1) / n + 15) / 16 * 16;
    const long long a = min(chunk, piece * per);
    lo = (put ? s_off : 0) + sp.off[j] * rb + a;
    hi = (put ? s_off : 0) + sp.off[j] * rb + min(chunk, a + per);
  }
};

__global__ void kv_stream_push_kernel(Stream x, Spans sp, const long long* flags, int* count,
                                      int salt, int jitter) {
  shmem::comm_jitter(x.me, salt, jitter, x.world);
  int put, j, piece;
  x.item(blockIdx.x, put, j, piece);
  long long lo, hi;
  x.bytes(sp, put, j, piece, lo, hi);
  const unsigned char* src = (put ? x.s_src - x.s_off : x.src) + lo;
  unsigned char* land = shmem::peer_ptr<unsigned char>(x.ws, x.mirror()) + x.region + lo;
  shmem::putmem_nbi_block(land, src, hi - lo);
  // the scale chunks' slots are step 1's: slot MAX_SPANS + j
  const ChunkFlags f = {nullptr, shmem::peer_ptr<int>(flags, x.mirror()), count, x.epoch};
  shmem::chunk_piece_done(f, put, j, put ? x.s_pieces : x.pieces);
}

__global__ void kv_stream_collect_kernel(Stream x, Spans sp, const long long* flags,
                                         WaitCtx w) {
  const int* mine = shmem::peer_ptr<int>(flags, x.me);
  const unsigned char* land = shmem::peer_ptr<unsigned char>(x.ws, x.me) + x.region;
  const int total = x.items(sp);
  int waited = -1;
  for (int u = blockIdx.x; u < total; u += gridDim.x) {
    int put, j, piece;
    x.item(u, put, j, piece);
    const int slot = ChunkFlags::slot(put, j);
    if (slot != waited) {  // flags only rise: one wait per slot and block
      // the payload's chunk 0 first, which the mirror issues first: a
      // mirror that never comes is named by that site, whichever block's
      // clock runs out first
      if (slot != 0)
        shmem::wait_block(mine, x.epoch, w, x.world, shmem::KIND_SIGNAL);
      shmem::wait_block(mine + slot, x.epoch, w, x.world + slot, shmem::KIND_SIGNAL);
      waited = slot;
    }
    long long lo, hi;
    x.bytes(sp, put, j, piece, lo, hi);
    unsigned char* dst = (put ? x.s_out - x.s_off : x.out) + lo;
    shmem::putmem_nbi_block(dst, land + lo, hi - lo);
  }
}

bool make_spans(const int* spans, int n_spans, int m, Spans& sp) {
  if (n_spans < 1 || n_spans > MAX_SPANS) return false;
  int next = 0;
  sp.n = n_spans;
  for (int j = 0; j < MAX_SPANS; ++j) {
    sp.off[j] = j < n_spans ? spans[2 * j] : 0;
    sp.rows[j] = j < n_spans ? spans[2 * j + 1] : 0;
    if (j < n_spans && (sp.off[j] != next || sp.rows[j] < 1)) return false;
    if (j < n_spans) next += sp.rows[j];
  }
  return next == m;
}

bool make_stream(const void* src, const void* s_src, void* out, void* s_out, long long row_bytes,
                 int m, const void* ws, long long region, long long s_off, int pieces,
                 int s_pieces, int n_puts, int world, int me, int epoch, Stream& x) {
  if (world < 2 || world > MAX_WORLD || world % 2 || me < 0 || me >= world || row_bytes < 1 ||
      m < 1 || pieces < 1 || pieces > MAX_PIECES || n_puts < 1 || n_puts > 2 ||
      (n_puts == 2 && (s_pieces < 1 || s_pieces > MAX_PIECES || s_off < m * row_bytes)) ||
      region % 16 != 0 || s_off % 16 != 0)
    return false;
  x.src = static_cast<const unsigned char*>(src);
  x.s_src = static_cast<const unsigned char*>(s_src);
  x.out = static_cast<unsigned char*>(out);
  x.s_out = static_cast<unsigned char*>(s_out);
  x.ws = static_cast<const long long*>(ws);
  x.region = region;
  x.s_off = s_off;
  x.row_bytes = row_bytes;
  x.pieces = pieces;
  x.s_pieces = n_puts == 2 ? s_pieces : 0;
  x.n_puts = n_puts;
  x.world = world;
  x.me = me;
  x.epoch = epoch;
  return true;
}

}  // namespace

// K41 / K42, the push. src [m, row_bytes] this rank's slab and s_src its
// f32 row scales [m] (nullptr on the native wire, K41: n_puts 1); ws the
// workspace's device peer table, region this launch's region offset in
// every rank's workspace and s_off the scales' offset inside a region
// (16-byte aligned, past the slab); spans host int32[2 * n_spans]
// (offset, rows) covering m; pieces / s_pieces the pieces a chunk of the
// slab / the scales moves in (1..1024); flags the device peer table of the
// int32[2 * MAX_SPANS] flag sets; count this rank's int32[2 * MAX_SPANS]
// piece counts (zero between launches); salt the race-shaking salt.
extern "C" int tdt_kv_stream_push(const void* src, const void* s_src, long long row_bytes, int m,
                                  const void* ws, long long region, long long s_off,
                                  const int* spans, int n_spans, int pieces, int s_pieces,
                                  int n_puts, const void* flags, void* count, int world, int me,
                                  int epoch, int salt, int jitter, void* stream) {
  Stream x;
  Spans sp;
  if (!make_stream(src, s_src, nullptr, nullptr, row_bytes, m, ws, region, s_off, pieces,
                   s_pieces, n_puts, world, me, epoch, x) ||
      !make_spans(spans, n_spans, m, sp) || (n_puts == 2 && s_src == nullptr) || jitter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = n_spans * (pieces + (n_puts == 2 ? s_pieces : 0));
  kv_stream_push_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, sp, static_cast<const long long*>(flags), static_cast<int*>(count), salt, jitter);
  return static_cast<int>(cudaGetLastError());
}

// K41 / K42, the collect: out [m, row_bytes] and s_out [m] f32 (nullptr on
// the native wire) private, the push's layout arguments, the persistent
// grid's cap and the bounded-wait arguments. Issued only once every rank's
// push is.
extern "C" int tdt_kv_stream_collect(void* out, void* s_out, long long row_bytes, int m,
                                     const void* ws, long long region, long long s_off,
                                     const int* spans, int n_spans, int pieces, int s_pieces,
                                     int n_puts, const void* flags, int world, int me,
                                     int epoch, int max_blocks, void* diag,
                                     long long timeout_ns, int family, void* stream) {
  Stream x;
  Spans sp;
  if (!make_stream(nullptr, nullptr, out, s_out, row_bytes, m, ws, region, s_off, pieces,
                   s_pieces, n_puts, world, me, epoch, x) ||
      !make_spans(spans, n_spans, m, sp) || (n_puts == 2 && s_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  WaitCtx wc;
  wc.diag = static_cast<int*>(diag);
  wc.timeout_ns = timeout_ns;
  wc.rank = me;
  wc.family = family;
  const int items = n_spans * (pieces + (n_puts == 2 ? s_pieces : 0));
  const int cap = max_blocks > 0 ? max_blocks : 1;
  kv_stream_collect_kernel<<<items < cap ? items : cap, 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      x, sp, static_cast<const long long*>(flags), wc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
