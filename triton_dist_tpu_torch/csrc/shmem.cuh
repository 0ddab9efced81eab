// B1 · the device side of the SHMEM surface the distributed kernels share
// (≙ triton_dist_tpu/shmem/device.py): puts, put-with-signal, signal,
// bounded waits, quiet, the all-rank barrier, the ring neighbours' barrier,
// the race-shaking delay, the chunked surface of the ring kernels
// (csrc/ring.cu): per-(step, chunk) puts with a flag slot of their own and
// the bounded per-chunk wait, and the all-to-all's chunked put with a flag
// slot per (sender, chunk) (csrc/a2a.cu), and the ring launch (Ring) the
// ring kernels share (csrc/ring.cu, csrc/ring_attention.cu).
//
// Symmetric memory: every rank holds one allocation of the same shape per
// symmetric buffer, and a device-side int64[world] table of the ranks'
// base addresses (shmem/host.py). A kernel reaches a peer's buffer through
// that table. With all ranks on one card these are plain device pointers;
// across cards they are UVA pointers after cudaDeviceEnablePeerAccess.
//
// Flags are int32 and carry epochs: a family's n-th launch signals the
// value n and waits for flag >= n, so no flag is ever reset under a peer
// (the cross-launch aliasing that shmem/device.py:702-709 describes for the
// TPU's barrier semaphore cannot happen).
//
// Memory ordering: data is written before its flag, the flag with
// st.release.sys after __threadfence_system(); waits read with
// ld.acquire.sys. The .sys scope holds across cards too.
//
// Bounded waits (≙ resilience/watchdog.py:122 bounded_wait): a wait spins
// on %globaltimer up to WaitCtx::timeout_ns; on expiry it writes one record
// into the rank's diagnostic buffer (first record wins, layout of
// resilience/records.py) and returns false. The kernel goes on and issues
// its later signals, so a rank that timed out never stalls its peers; its
// later waits fail at once. The host reads the buffer after the rank's
// stream syncs and raises with the record.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace shmem {

// records.py slots and status / kind codes (sites.py)
enum { F_STATUS = 0, F_FAMILY, F_RANK, F_SITE, F_KIND, F_EXPECTED, F_OBSERVED, F_TIMEOUT_US };
enum { STATUS_OK = 0, STATUS_TIMEOUT = 1 };
enum { KIND_SIGNAL = 1, KIND_WAIT = 2, KIND_BARRIER = 3 };

struct WaitCtx {
  int* diag;             // int32[8] of this rank
  long long timeout_ns;  // per wait
  int rank;
  int family;
};

__device__ __forceinline__ int ld_acquire_sys(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release_sys(int* p, int v) {
  asm volatile("st.release.sys.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void red_add_release_sys(int* p, int v) {
  asm volatile("red.release.sys.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <typename T>
__device__ __forceinline__ T* peer_ptr(const long long* table, int rank) {
  return reinterpret_cast<T*>(table[rank]);
}

// Write the timeout record, once per rank buffer.
__device__ __forceinline__ void record_timeout(const WaitCtx& w, int site, int kind,
                                               int expected, int observed) {
  if (atomicCAS(w.diag + F_STATUS, STATUS_OK, STATUS_TIMEOUT) == STATUS_OK) {
    w.diag[F_FAMILY] = w.family;
    w.diag[F_RANK] = w.rank;
    w.diag[F_SITE] = site;
    w.diag[F_KIND] = kind;
    w.diag[F_EXPECTED] = expected;
    w.diag[F_OBSERVED] = observed;
    w.diag[F_TIMEOUT_US] = static_cast<int>(w.timeout_ns / 1000);
    __threadfence_system();
  }
}

// signal_wait_until / wait (shmem/device.py:638, :647): spin until
// *flag >= expected, bounded. Returns false on timeout (record written) or
// at once when this rank already recorded one (fast fail).
__device__ __forceinline__ bool wait_until_ge(const int* flag, int expected, const WaitCtx& w,
                                              int site, int kind) {
  int seen = ld_acquire_sys(flag);
  if (seen >= expected) return true;
  if (*reinterpret_cast<volatile int*>(w.diag + F_STATUS) != STATUS_OK) return false;
  const unsigned long long t0 = globaltimer();
  while (true) {
    __nanosleep(64);
    seen = ld_acquire_sys(flag);
    if (seen >= expected) return true;
    if (globaltimer() - t0 > static_cast<unsigned long long>(w.timeout_ns)) break;
  }
  record_timeout(w, site, kind, expected, seen);
  return false;
}

// The block waits on one flag: thread 0 spins, the block meets after it.
__device__ __forceinline__ void wait_block(const int* flag, int expected, const WaitCtx& w,
                                           int site, int kind) {
  if (threadIdx.x == 0) {
    wait_until_ge(flag, expected, w, site, kind);
    __threadfence();
  }
  __syncthreads();
}

// signal_op (shmem/device.py:596): SET (release store) or ADD (release
// reduction) on a local or peer flag.
__device__ __forceinline__ void signal_set(int* flag, int value) { st_release_sys(flag, value); }
__device__ __forceinline__ void signal_add(int* flag, int inc) { red_add_release_sys(flag, inc); }

// quiet (shmem/device.py:668): every store this thread issued, local or
// peer, is complete and visible system-wide.
__device__ __forceinline__ void quiet() { __threadfence_system(); }

// putmem_nbi_block (shmem/device.py:207): the block copies `bytes` from
// local `src` into `dst` (a peer's symmetric buffer): 16-byte vectors while
// both ends are 16-byte aligned, bytes for the tail.
__device__ __forceinline__ void putmem_nbi_block(void* dst, const void* src, long long bytes) {
  const bool vec = (reinterpret_cast<uintptr_t>(dst) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(src) % 16 == 0);
  long long done = 0;
  if (vec) {
    const long long n16 = bytes / 16;
    uint4* d = static_cast<uint4*>(dst);
    const uint4* s = static_cast<const uint4*>(src);
    for (long long i = threadIdx.x; i < n16; i += blockDim.x) d[i] = s[i];
    done = n16 * 16;
  }
  unsigned char* d8 = static_cast<unsigned char*>(dst);
  const unsigned char* s8 = static_cast<const unsigned char*>(src);
  for (long long i = done + threadIdx.x; i < bytes; i += blockDim.x) d8[i] = s8[i];
}

// putmem_signal_nbi_block (shmem/device.py:239): the put, then one flag
// write that orders after every thread's part of it.
__device__ __forceinline__ void putmem_signal_nbi_block(void* dst, const void* src,
                                                        long long bytes, int* sig, int value) {
  putmem_nbi_block(dst, src, bytes);
  quiet();
  __syncthreads();
  if (threadIdx.x == 0) signal_set(sig, value);
}

// barrier_all (shmem/device.py:693) on a full mesh, in its two halves.
// Arrive: thread t < world writes epoch into peer t's slot `me` of the
// int32[world] flag set (`flags` is its peer table). Wait: thread t waits
// for its own slot t to reach epoch; the sites are the peer ranks. One warp
// each. The host issues every rank's arrive before any rank's wait (see
// csrc/dist.cu), so a wait never depends on work issued after it.
__device__ __forceinline__ void barrier_arrive_warp(const long long* flags, int world, int me,
                                                    int epoch) {
  const int t = threadIdx.x;
  if (t < world && t != me) signal_set(peer_ptr<int>(flags, t) + me, epoch);
}

__device__ __forceinline__ void barrier_wait_warp(const long long* flags, int world, int me,
                                                  int epoch, const WaitCtx& w) {
  const int t = threadIdx.x;
  if (t < world && t != me) wait_until_ge(peer_ptr<int>(flags, me) + t, epoch, w, t, KIND_BARRIER);
  __syncwarp();
}

// barrier_neighbors (shmem/device.py:756): a bounded barrier with the two
// ring neighbours only, the entry handshake of the bidirectional ring.
// Block 0 writes `epoch` into both neighbours' slots of this rank's
// arrival; every block then waits for the right neighbour's arrival, and
// only once it has come for the left one's. So a neighbour that never comes
// is always named by the same site (its rank), whichever block's clock runs
// out first. At world 2 both neighbours are one rank and one slot.
struct Neighbours {
  int* to_left;           // the left neighbour's slot of this rank's arrival
  int* to_right;          // the right neighbour's slot of it
  const int* from_right;  // this rank's slot of the right neighbour's arrival
  const int* from_left;   // and of the left neighbour's
  int left, right;
};

__device__ __forceinline__ void barrier_neighbors(const Neighbours& nb, int epoch,
                                                  const WaitCtx& w) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    signal_set(nb.to_left, epoch);
    signal_set(nb.to_right, epoch);
  }
  if (threadIdx.x == 0) {
    if (wait_until_ge(nb.from_right, epoch, w, nb.right, KIND_BARRIER))
      wait_until_ge(nb.from_left, epoch, w, nb.left, KIND_BARRIER);
    __threadfence();
  }
  __syncthreads();
}

// comm_jitter (shmem/device.py:116): race shaking. Thread 0 of every block
// runs base * (1 + (rank * 7919 + salt * 104729) mod 8) dependent integer
// steps (the JAX package's spread, 1x to 8x per (rank, salt)) while the
// block waits, so the ranks issue their stores and waits at different
// times. A no-op when base is 0 and at world 1; it changes when a kernel
// acts, never what it computes.
__device__ __forceinline__ void comm_jitter(int rank, int salt, int base, int world) {
  if (base <= 0 || world <= 1) return;
  if (threadIdx.x == 0) {
    const long long iters =
        static_cast<long long>(base) * (1 + (rank * 7919 + salt * 104729) % 8);
    unsigned v = static_cast<unsigned>(rank);
    for (long long i = 0; i < iters; ++i) {
      v = v * 1664525u + 1013904223u;
      asm volatile("" : "+r"(v));  // one step per iteration: nothing to fold
    }
  }
  __syncthreads();
}

// ------------------------------------------------- the chunked surface ----
//
// A ring kernel moves each hop's payload in spans ("chunks") of a shard's
// rows (chunk_schedule, ops/common.py). Chunk j of step s has flag slot
// s * MAX_SPANS + j in the receiver's int32 flag set; the sender raises it
// to the launch's epoch once every piece of the chunk has landed, and the
// receiver's wait on that slot is its landing view of the chunk.

constexpr int MAX_SPANS = 16;

// The spans of a shard, by value: span j covers rows [off[j], off[j] +
// rows[j]) of it.
struct Spans {
  int off[MAX_SPANS];
  int rows[MAX_SPANS];
  int n;
};

// ChunkedPutHandle (shmem/device.py:248): where one launch's (step,
// chunk) slots of one direction live. `mine` are this rank's arrival flags
// (raised by the neighbour it receives from), `peer` the flags of the
// neighbour it sends to, `count` this rank's per-slot count of finished
// pieces (zero between launches).
struct ChunkFlags {
  int* mine;
  int* peer;
  int* count;
  int epoch;

  static __device__ __forceinline__ int slot(int step, int chunk) {
    return step * MAX_SPANS + chunk;
  }
};

// putmem_signal_chunked_nbi_block / putmem_signal2_nbi_block
// (shmem/device.py:308, :435), the signal half: the block has stored its
// piece of chunk `chunk` of step `step` (a put, or an epilogue's stores
// into the peer's landing view); once all `pieces` pieces are in, the
// block that finishes last raises the peer's slot, ordered after every
// piece by the fences (the count is reset for the next launch first).
__device__ __forceinline__ void chunk_piece_done(const ChunkFlags& f, int step, int chunk,
                                                 int pieces) {
  quiet();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int s = ChunkFlags::slot(step, chunk);
    if (atomicAdd(f.count + s, 1) == pieces - 1) {
      f.count[s] = 0;
      __threadfence_system();
      signal_set(f.peer + s, f.epoch);
    }
  }
}

// The same for a group of `threads` threads (whole warps) of a warp-
// specialised block, which meets on named barrier `bar` (1..15) and not at
// __syncthreads; `leader` is one thread of the group.
__device__ __forceinline__ void chunk_piece_done_group(const ChunkFlags& f, int step, int chunk,
                                                       int pieces, int bar, int threads,
                                                       bool leader) {
  quiet();
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(threads) : "memory");
  if (leader) {
    const int s = ChunkFlags::slot(step, chunk);
    if (atomicAdd(f.count + s, 1) == pieces - 1) {
      f.count[s] = 0;
      __threadfence_system();
      signal_set(f.peer + s, f.epoch);
    }
  }
}

// putmem_signal_chunked_a2a_nbi_block (shmem/device.py:373), the
// all-to-all's chunked put (csrc/a2a.cu): the block puts its piece of
// chunk `chunk` of the slab bound for rank `dst` into that rank's landing
// view, and the block that lands the chunk's last of `pieces` pieces raises
// the receiver's (sender, chunk) slot, me * MAX_SPANS + chunk of the flag
// set whose peer table is `flags`. `count` is this rank's int32[world *
// MAX_SPANS] of finished pieces per (destination, chunk).
__device__ __forceinline__ void putmem_signal_chunked_a2a_block(void* dst_ptr, const void* src,
                                                                long long bytes,
                                                                const long long* flags,
                                                                int* count, int dst, int me,
                                                                int chunk, int pieces,
                                                                int epoch) {
  putmem_nbi_block(dst_ptr, src, bytes);
  const ChunkFlags f = {nullptr, peer_ptr<int>(flags, dst) + me * MAX_SPANS,
                        count + dst * MAX_SPANS, epoch};
  chunk_piece_done(f, 0, chunk, pieces);
}

// wait_chunk (shmem/device.py:492): the block waits, bounded, until chunk
// `chunk` of the sending neighbour's step-`step` put has landed. The site
// is site_base + slot (resilience/sites.py: site_base is the world for the
// chunks that travel right, world + (world - 1) * MAX_SPANS for those that
// travel left).
__device__ __forceinline__ void wait_chunk(const ChunkFlags& f, int step, int chunk,
                                           int site_base, const WaitCtx& w) {
  const int s = ChunkFlags::slot(step, chunk);
  wait_block(f.mine + s, f.epoch, w, site_base + s, KIND_SIGNAL);
}

// ------------------------------------------------------ a ring launch ----
//
// One rank's side of a ring kernel's launch (csrc/ring.cu,
// csrc/ring_attention.cu): its neighbours, the entry handshake, the
// (step, chunk) flags of the chunks that travel right, the bounded-wait
// context and the race-shaking delay.

constexpr int RING_MAX_WORLD = 8;

struct Ring {
  int world, me;
  const int* entry_wait;  // this rank's slot of its right neighbour's arrival
  int* entry_signal;      // the left neighbour's slot of this rank's arrival
  ChunkFlags f;
  WaitCtx w;
  int jitter;             // comm_jitter's base (0: none)

  __device__ __forceinline__ int right() const { return (me + 1) % world; }
  __device__ __forceinline__ int left() const { return (me - 1 + world) % world; }

  // a kernel's first act: tell the left neighbour this rank has started,
  // then wait (bounded) until the right neighbour has, before any store
  // into its buffers and before any other wait, so a neighbour that never
  // comes is what a timeout names
  __device__ __forceinline__ void enter() const {
    if (blockIdx.x == 0 && threadIdx.x == 0) signal_set(entry_signal, f.epoch);
    wait_block(entry_wait, f.epoch, w, right(), KIND_BARRIER);
  }

  // before a block's first item of (step, chunk), step > 0: the left
  // neighbour's chunk of step - 1 has landed
  __device__ __forceinline__ void wait_landed(int step, int chunk, int& waited) const {
    const int key = ChunkFlags::slot(step, chunk);
    if (step == 0 || key == waited) return;
    wait_chunk(f, step - 1, chunk, world, w);
    waited = key;
  }

  // the same wait (step > 0) by one thread of a warp-specialised block, at
  // the same site: true once the chunk has landed, false on a timeout
  __device__ __forceinline__ bool wait_landed_thread(int step, int chunk) const {
    const int s = ChunkFlags::slot(step - 1, chunk);
    return wait_until_ge(f.mine + s, f.epoch, w, world + s, KIND_SIGNAL);
  }
};

// A Ring from the host's launch arguments; false for a world it cannot be.
inline bool make_ring(int world, int me, int epoch, void* entry_wait, void* entry_signal,
                      void* flags_me, void* flags_right, void* count, int jitter, void* diag,
                      long long timeout_ns, int family, Ring& r) {
  if (world < 2 || world > RING_MAX_WORLD || me < 0 || me >= world || jitter < 0) return false;
  r.world = world;
  r.me = me;
  r.entry_wait = static_cast<const int*>(entry_wait);
  r.entry_signal = static_cast<int*>(entry_signal);
  r.f.mine = static_cast<int*>(flags_me);
  r.f.peer = static_cast<int*>(flags_right);
  r.f.count = static_cast<int*>(count);
  r.f.epoch = epoch;
  r.w.diag = static_cast<int*>(diag);
  r.w.timeout_ns = timeout_ns;
  r.w.rank = me;
  r.w.family = family;
  r.jitter = jitter;
  return true;
}

}  // namespace shmem
