// K35 · ring attention (tdt_ring_attention): sequence-parallel attention of
// each rank's query rows against every rank's key/value rows, the K/V
// chunks travelling right around the ring.
//   out = softmax(q k^T / sqrt(d), causal by global position) v
//   lse = m + log(max(l, 1e-30)) per query row
// q, k, v [bh, s_loc, d] this rank's sequence shard (bf16 or f32), out in
// q's type, lse f32 [bh, s_loc].
//
// Replaces triton_dist_tpu/ops/ring_attention.py:145 _ring_attention_kernel
// (launched at :289 by ring_attention): at step s rank me holds the chunk
// of rank (me - s) mod n, forwards it to its right neighbour before
// computing on it, and carries the online softmax (m, l, acc) in f32
// across the steps; the last step writes out and the per-row lse. The
// causal mask compares global positions (_tile_offset, :48-66): contig
// rank r owns rows [r s_loc, (r+1) s_loc); zigzag rank r owns stripes r and
// 2n-1-r of s_loc/2 rows each, and no tile straddles the stripe boundary.
//
// What bounds it on the H100: 4 bh s_loc S d operations a rank (half under
// the causal mask) against 2 bh S d bytes of K/V read: at S = 16384 that is
// thousands of operations a byte, so it is bound by operations, and in bf16
// only the tensor cores can approach that bound.
//
// What the design does about it. One persistent kernel a rank (at most
// floor(SMs / ranks) - 2 blocks at world > 1, so every rank's spinning
// blocks are resident together), its work one list in step order: step
// s's forward pieces (256 KB of the [k | v] chunk copied into the right
// neighbour's landing slot s; the block that lands the last piece raises
// the neighbour's step-s flag, shmem.cuh chunk_piece_done), then step s's
// query tiles. Tile t is always block t % grid's, so the (m, l, acc) state
// a tile leaves in f32 device memory at step s is read back by the same
// block at step s+1. An item of step s > 0 first waits (bounded) for the
// left neighbour's step s-1 flag, which sits earlier in that neighbour's
// list: by induction over the steps every wait is met. Every block starts
// with the ring's entry handshake (Ring::enter: the right neighbour's
// arrival, before any store into its buffers), so a late neighbour is
// named by a fixed site; the first data wait is for the chunk of the left
// neighbour (its step-0 put). A query tile whose KV tiles are all masked
// at a step skips it without touching its state. At world 1 there is no
// put, no handshake and no state: one step writes out and lse.
//
// bf16: 128 query rows a block, 16 a warp; Q.K^T and P.V are m16n8k16
// mma.sync products fed by ldmatrix from shared memory (P rounded to bf16
// for P.V, its row sums kept in f32), KV tiles of 64 positions
// double-buffered with 16-byte cp.async (csrc/flash_verify.cu's K13 tile,
// on gemm_core.cuh's mma helpers).
// f32 (the reference precision): 32 rows a block, scores, softmax and P.V
// in FMA from shared memory. wgmma, TMA and warp specialisation are later
// work.

#include <math.h>

#include "gemm_core.cuh"
#include "shmem.cuh"

namespace {

using namespace tdt;  // bf16, DType, cdiv, cp.async, ldmatrix, mma_bf16
using shmem::Ring;

constexpr long long PIECE_BYTES = 256 * 1024;  // one forward piece
constexpr int TILE = 64;                       // key positions a step
constexpr int JITTER_SALT = 13;

struct Geo {
  int bh, s_loc, d, world, me, zigzag, causal;
  float scale;
  long long chunk;  // elements of one of k, v: bh * s_loc * d

  // the layout's segments: the whole shard (contig) or its two stripes
  __device__ __forceinline__ int n_seg() const { return zigzag ? 2 : 1; }
  __device__ __forceinline__ int seg_len() const { return zigzag ? s_loc / 2 : s_loc; }
  // global position of the first row of segment `seg` of rank `rank`
  __device__ __forceinline__ int seg_pos(int rank, int seg) const {
    if (!zigzag) return rank * s_loc;
    const int h = s_loc / 2;
    return seg == 0 ? rank * h : (2 * world - 1 - rank) * h;
  }
};

// One query tile of `rows` rows: (bh index, segment, first row in it), and
// what the key tiles of a chunk are.
struct Tile {
  int bhi, row0, rows, pos0;  // row0: local row of the tile's first row
  int kps, kv_tiles;          // key tiles a segment, in the chunk

  __device__ __forceinline__ Tile(const Geo& G, int t, int tile_rows) {
    const int sl = G.seg_len(), tps = cdiv(sl, tile_rows), n_qt = G.n_seg() * tps;
    bhi = t / n_qt;
    const int qt = t % n_qt, seg = qt / tps, q0 = (qt % tps) * tile_rows;
    rows = min(tile_rows, sl - q0);
    row0 = seg * sl + q0;
    pos0 = G.seg_pos(G.me, seg) + q0;
    kps = cdiv(sl, TILE);
    kv_tiles = G.n_seg() * kps;
  }
  // key tile `it` of rank kv_rank's chunk: its first local row, its rows,
  // the global position of its first row
  __device__ __forceinline__ void key(const Geo& G, int kv_rank, int it, int& k_row0,
                                      int& k_rows, int& k_pos0) const {
    const int sl = G.seg_len(), seg = it / kps, k0 = (it % kps) * TILE;
    k_row0 = seg * sl + k0;
    k_rows = min(TILE, sl - k0);
    k_pos0 = G.seg_pos(kv_rank, seg) + k0;
  }
  // the first key tile at or after `it` that is not masked for every row
  __device__ __forceinline__ int next_live(const Geo& G, int kv_rank, int it) const {
    for (; it < kv_tiles; ++it) {
      int r0, n, p0;
      key(G, kv_rank, it, r0, n, p0);
      if (!G.causal || p0 <= pos0 + rows - 1) break;
    }
    return it;
  }
};

// ------------------------------------------------------------ bf16 (mma) --

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// 128 query rows a block, 256 threads; warp w owns rows [16w, 16w + 16).
// In mma fragment terms a thread holds rows gid and gid + 8 (gid = lane /
// 4) and, of each 8-wide n tile, the columns 2 * (lane % 4) and +1.
template <int DP>
struct Mma {
  typedef bf16 T;
  static constexpr int ROWS = 128, THREADS = 256, LD = DP + 8, NT = DP / 8;
  static constexpr size_t SMEM = (size_t)(ROWS + 4 * TILE) * LD * sizeof(bf16);

  // `rows` of DP columns from `src` (rows of d elements) into `dst`: rows
  // at or past `valid` and columns past d are zero
  __device__ static __forceinline__ void stage(bf16* dst, const bf16* __restrict__ src,
                                               int rows, int valid, int d, int vec) {
    for (int e = threadIdx.x; e < rows * (DP / 8); e += THREADS) {
      const int r = e / (DP / 8), c = (e % (DP / 8)) * 8;
      bf16* out = dst + r * LD + c;
      if (r < valid && c < d) {
        const bf16* row = src + (size_t)r * d;
        if (vec) {
          cp_async16(out, row + c);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) out[i] = c + i < d ? row[c + i] : __float2bfloat16(0.f);
        }
      } else {
        *reinterpret_cast<uint4*>(out) = make_uint4(0, 0, 0, 0);
      }
    }
  }

  // query tile t against the chunk (kc, vc) of rank kv_rank at `step`
  __device__ static void attend(const bf16* __restrict__ q, const bf16* kc, const bf16* vc,
                                bf16* __restrict__ out, float* __restrict__ lse, float* m_st,
                                float* l_st, float* acc_st, const Geo& G, int t, int step,
                                int kv_rank, int vec, unsigned char* smem) {
    bf16* q_s = reinterpret_cast<bf16*>(smem);  // [ROWS][LD]
    bf16* k_s = q_s + ROWS * LD;                // [2][TILE][LD]
    bf16* v_s = k_s + 2 * TILE * LD;            // [2][TILE][LD]
    const Tile tile(G, t, ROWS);
    const bool last = step == G.world - 1;
    int it = tile.next_live(G, kv_rank, 0);
    // nothing of this chunk is visible to the tile: its state stands
    if (it == tile.kv_tiles && step > 0 && !last) return;
    const size_t head = (size_t)tile.bhi * G.s_loc;  // row (bhi, 0)
    const int d = G.d;
    __syncthreads();  // the block's previous item is done with shared memory
    stage(q_s, q + (head + tile.row0) * d, ROWS, tile.rows, d, vec);
    auto stage_kv = [&](int buf, int i) {
      int r0, n, p0;
      tile.key(G, kv_rank, i, r0, n, p0);
      stage(k_s + buf * TILE * LD, kc + (head + r0) * d, TILE, n, d, vec);
      stage(v_s + buf * TILE * LD, vc + (head + r0) * d, TILE, n, d, vec);
    };
    if (it < tile.kv_tiles) stage_kv(0, it);
    cp_async_commit();

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane / 4, tig = lane % 4;
    const int r_lo = warp * 16 + gid, r_hi = r_lo + 8;
    const int pos_lo = tile.pos0 + r_lo, pos_hi = tile.pos0 + r_hi;
    float o[NT][4];
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    if (step > 0) {  // the state this block left at the previous step
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r_hi : r_lo;
        if (r >= tile.rows) continue;
        const size_t gr = head + tile.row0 + r;
        (half ? m_hi : m_lo) = m_st[gr];
        (half ? l_hi : l_lo) = l_st[gr];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = nt * 8 + 2 * tig + e;
            if (c < d) o[nt][2 * half + e] = acc_st[gr * d + c];
          }
      }
    }
    const bf16* q_w = q_s + warp * 16 * LD;
    int buf = 0;
    while (it < tile.kv_tiles) {
      const int nxt = tile.next_live(G, kv_rank, it + 1);
      if (nxt < tile.kv_tiles) {
        stage_kv(buf ^ 1, nxt);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* kt = k_s + buf * TILE * LD;
      const bf16* vt = v_s + buf * TILE * LD;
      int k_row0, k_rows, k_pos0;
      tile.key(G, kv_rank, it, k_row0, k_rows, k_pos0);

      // (a) S = Q . K^T over the tile: 8 n tiles of 8 positions
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        unsigned a[4];
        ldmatrix_x4(a, q_w + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned bfr[4];
          const int mi = lane / 8;
          ldmatrix_x4(bfr, kt + (np * 16 + (mi / 2) * 8 + lane % 8) * LD + kk * 16 +
                               (mi % 2) * 8);
          mma_bf16(s[2 * np], a, bfr);
          mma_bf16(s[2 * np + 1], a, bfr + 2);
        }
      }
      // (b) scale, the key tile's extent and the causal mask; the online
      // softmax update of the thread's two rows
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = nt * 8 + 2 * tig + (e & 1);
          const bool ok = j < k_rows && (!G.causal || k_pos0 + j <= (e < 2 ? pos_lo : pos_hi));
          const float sc = ok ? s[nt][e] * G.scale : -INFINITY;
          s[nt][e] = sc;
          if (e < 2) mx_lo = fmaxf(mx_lo, sc); else mx_hi = fmaxf(mx_hi, sc);
        }
      }
#pragma unroll
      for (int o_ = 1; o_ < 4; o_ <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o_));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o_));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      // a row masked so far keeps m = -inf; its shift stays finite
      const float ms_lo = fmaxf(mn_lo, -1e30f), ms_hi = fmaxf(mn_hi, -1e30f);
      const float al_lo = expf(m_lo - ms_lo), al_hi = expf(m_hi - ms_hi);
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = expf(s[nt][0] - ms_lo);
        s[nt][1] = expf(s[nt][1] - ms_lo);
        s[nt][2] = expf(s[nt][2] - ms_hi);
        s[nt][3] = expf(s[nt][3] - ms_hi);
        sum_lo += s[nt][0] + s[nt][1];
        sum_hi += s[nt][2] + s[nt][3];
      }
#pragma unroll
      for (int o_ = 1; o_ < 4; o_ <<= 1) {
        sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, o_);
        sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, o_);
      }
      l_lo = l_lo * al_lo + sum_lo;
      l_hi = l_hi * al_hi + sum_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][0] *= al_lo;
        o[nt][1] *= al_lo;
        o[nt][2] *= al_hi;
        o[nt][3] *= al_hi;
      }
      // (c) O += P . V, P rounded to bf16 (the accumulator layout of two
      // neighbouring n tiles is the A fragment of one 16-deep k step)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned a[4];
        a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
        a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
        a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned bfr[4];
          const int mi = lane / 8;
          ldmatrix_x4_trans(bfr, vt + (j * 16 + (mi % 2) * 8 + lane % 8) * LD + np * 16 +
                                     (mi / 2) * 8);
          mma_bf16(o[2 * np], a, bfr);
          mma_bf16(o[2 * np + 1], a, bfr + 2);
        }
      }
      __syncthreads();
      buf ^= 1;
      it = nxt;
    }
    cp_async_wait<0>();  // nothing in flight at exit (no live key tile)

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r_hi : r_lo;
      if (r >= tile.rows) continue;
      const float l = half ? l_hi : l_lo, m = half ? m_hi : m_lo;
      const size_t gr = head + tile.row0 + r;
      if (last) {
        const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = nt * 8 + 2 * tig + e;
            if (c < d) out[gr * d + c] = __float2bfloat16(o[nt][2 * half + e] * inv);
          }
        if (tig == 0) lse[gr] = m + logf(fmaxf(l, 1e-30f));
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = nt * 8 + 2 * tig + e;
            if (c < d) acc_st[gr * d + c] = o[nt][2 * half + e];
          }
        if (tig == 0) {
          m_st[gr] = m;
          l_st[gr] = l;
        }
      }
    }
  }
};

// ------------------------------------------------------------- f32 (FMA) --

// 32 query rows a block, 128 threads. Per 64-position key tile: thread t
// scores position t % 64 against rows t / 64, +2, ...; one warp per row
// updates its (m, l); then thread t owns output column t (and t + 128) of
// every row. dp: the head dim padded to a power of two (>= 4, <= 256).
struct Fma {
  typedef float T;
  static constexpr int ROWS = 32, THREADS = 128, HALF = ROWS / 2;

  static size_t smem_bytes(int dp) {
    return ((size_t)ROWS * dp + 2 * (size_t)TILE * (dp + 4) + (size_t)ROWS * TILE +
            3 * ROWS) * sizeof(float);
  }

  __device__ static void attend(const float* __restrict__ q, const float* kc, const float* vc,
                                float* __restrict__ out, float* __restrict__ lse,
                                float* m_st, float* l_st, float* acc_st, const Geo& G, int t,
                                int step, int kv_rank, int dp, unsigned char* smem) {
    const int ld = dp + 4;
    float* q_s = reinterpret_cast<float*>(smem);  // [ROWS][dp]
    float* k_s = q_s + ROWS * dp;                  // [TILE][ld]
    float* v_s = k_s + TILE * ld;                  // [TILE][ld]
    float* p_s = v_s + TILE * ld;                  // [ROWS][TILE]
    float* m_s = p_s + ROWS * TILE;                // [ROWS]
    float* l_s = m_s + ROWS;
    float* alpha_s = l_s + ROWS;
    const Tile tile(G, t, ROWS);
    const bool last = step == G.world - 1;
    int it = tile.next_live(G, kv_rank, 0);
    if (it == tile.kv_tiles && step > 0 && !last) return;
    const size_t head = (size_t)tile.bhi * G.s_loc;
    const int d = G.d;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    __syncthreads();  // the block's previous item is done with shared memory
    for (int e = threadIdx.x; e < ROWS * dp; e += THREADS) {
      const int r = e / dp, c = e % dp;
      q_s[e] = (r < tile.rows && c < d) ? q[(head + tile.row0 + r) * d + c] : 0.f;
    }
    if (threadIdx.x < ROWS) {
      const int r = threadIdx.x;
      const bool keep = step > 0 && r < tile.rows;
      m_s[r] = keep ? m_st[head + tile.row0 + r] : -INFINITY;
      l_s[r] = keep ? l_st[head + tile.row0 + r] : 0.f;
    }
    float acc[2][ROWS];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = threadIdx.x + cc * THREADS;
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        acc[cc][r] = step > 0 && c < d && r < tile.rows ? acc_st[(head + tile.row0 + r) * d + c] : 0.f;
    }
    __syncthreads();  // m_s and l_s are read by every thread, even with no key tile to go
    const int p_own = threadIdx.x % TILE, rh = threadIdx.x / TILE;

    for (; it < tile.kv_tiles; it = tile.next_live(G, kv_rank, it + 1)) {
      int k_row0, k_rows, k_pos0;
      tile.key(G, kv_rank, it, k_row0, k_rows, k_pos0);
      for (int e = threadIdx.x; e < TILE * dp; e += THREADS) {
        const int p = e / dp, c = e % dp;
        const bool ok = p < k_rows && c < d;
        const size_t src = (head + k_row0 + p) * d + c;
        k_s[p * ld + c] = ok ? kc[src] : 0.f;
        v_s[p * ld + c] = ok ? vc[src] : 0.f;
      }
      __syncthreads();
      // (a) scores of position p_own against rows rh, rh + 2, ...
      {
        float s[HALF];
#pragma unroll
        for (int i = 0; i < HALF; ++i) s[i] = 0.f;
        const float* kr = k_s + p_own * ld;
        for (int c = 0; c < dp; c += 4) {
          const float4 kf = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
          for (int i = 0; i < HALF; ++i) {
            const float4 qf = *reinterpret_cast<const float4*>(q_s + (rh + 2 * i) * dp + c);
            s[i] = fmaf(qf.x, kf.x, s[i]);
            s[i] = fmaf(qf.y, kf.y, s[i]);
            s[i] = fmaf(qf.z, kf.z, s[i]);
            s[i] = fmaf(qf.w, kf.w, s[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < HALF; ++i) {
          const int r = rh + 2 * i;
          const bool ok = p_own < k_rows && (!G.causal || k_pos0 + p_own <= tile.pos0 + r);
          p_s[r * TILE + p_own] = ok ? s[i] * G.scale : -INFINITY;
        }
      }
      __syncthreads();
      // (b) each row's online-softmax update; p_s becomes exp(s - m_safe)
      for (int r = warp; r < ROWS; r += THREADS / 32) {
        float* pr = p_s + r * TILE;
        float mx = fmaxf(pr[lane], pr[lane + 32]);
#pragma unroll
        for (int o_ = 16; o_ > 0; o_ >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        const float m_safe = fmaxf(m_new, -1e30f);
        const float e0 = expf(pr[lane] - m_safe), e1 = expf(pr[lane + 32] - m_safe);
        pr[lane] = e0;
        pr[lane + 32] = e1;
        float sum = e0 + e1;
#pragma unroll
        for (int o_ = 16; o_ > 0; o_ >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o_);
        if (lane == 0) {
          const float alpha = expf(m_old - m_safe);
          alpha_s[r] = alpha;
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();
      // (c) acc = acc * alpha + P . V over this thread's columns
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int c = threadIdx.x + cc * THREADS;
        if (c < dp) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[cc][r] *= alpha_s[r];
          for (int p = 0; p < TILE; ++p) {
            const float vv = v_s[p * ld + c];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) acc[cc][r] = fmaf(p_s[r * TILE + p], vv, acc[cc][r]);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = threadIdx.x + cc * THREADS;
      if (c >= d) continue;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= tile.rows) continue;
        const size_t gi = (head + tile.row0 + r) * d + c;
        if (last)
          out[gi] = acc[cc][r] / fmaxf(l_s[r], 1e-30f);
        else
          acc_st[gi] = acc[cc][r];
      }
    }
    if (threadIdx.x < ROWS && threadIdx.x < tile.rows) {
      const int r = threadIdx.x;
      const size_t gr = head + tile.row0 + r;
      if (last) {
        lse[gr] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
      } else {
        m_st[gr] = m_s[r];
        l_st[gr] = l_s[r];
      }
    }
  }
};

// ------------------------------------------------------- the ring kernel --

template <class A>
__global__ void __launch_bounds__(A::THREADS)
    ring_attention_kernel(const typename A::T* __restrict__ q, const typename A::T* k,
                          const typename A::T* v, typename A::T* out, float* lse, float* m_st,
                          float* l_st, float* acc_st, const typename A::T* land_me,
                          typename A::T* land_right, Geo G, Ring r, int arg) {
  typedef typename A::T T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = G.world;
  if (n > 1) {
    shmem::comm_jitter(G.me, JITTER_SALT, r.jitter, n);
    r.enter();
  }
  const int sl = G.seg_len();
  const int tiles = G.bh * G.n_seg() * cdiv(sl, A::ROWS);
  const long long chunk_bytes = G.chunk * (long long)sizeof(T);
  const int pieces = static_cast<int>((2 * chunk_bytes + PIECE_BYTES - 1) / PIECE_BYTES);
  int waited = -1;
  for (int s = 0; s < n; ++s) {
    // the chunk held at step s: rank me - s's, in a landing slot [k | v]
    const T* kc = s == 0 ? k : land_me + (size_t)(s - 1) * 2 * G.chunk;
    const T* vc = s == 0 ? v : kc + G.chunk;
    if (s < n - 1) {  // forward it before computing on it
      unsigned char* dst = reinterpret_cast<unsigned char*>(land_right + (size_t)s * 2 * G.chunk);
      for (int p = blockIdx.x; p < pieces; p += gridDim.x) {
        r.wait_landed(s, 0, waited);
        const long long lo = p * PIECE_BYTES;
        const long long hi = min(2 * chunk_bytes, lo + PIECE_BYTES);
        auto put = [&](long long a, long long b) {
          const unsigned char* src = a < chunk_bytes
              ? reinterpret_cast<const unsigned char*>(kc) + a
              : reinterpret_cast<const unsigned char*>(vc) + (a - chunk_bytes);
          shmem::putmem_nbi_block(dst + a, src, b - a);
        };
        if (lo < chunk_bytes && hi > chunk_bytes) {
          put(lo, chunk_bytes);
          put(chunk_bytes, hi);
        } else {
          put(lo, hi);
        }
        shmem::chunk_piece_done(r.f, s, 0, pieces);
      }
    }
    const int kv_rank = (G.me - s + n) % n;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      r.wait_landed(s, 0, waited);
      A::attend(q, kc, vc, out, lse, m_st, l_st, acc_st, G, t, s, kv_rank, arg, smem);
    }
  }
}

template <class A>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse, void* m_st,
                   void* l_st, void* acc_st, const void* land_me, void* land_right,
                   const Geo& G, const Ring& r, int max_blocks, int arg, size_t smem,
                   cudaStream_t s) {
  typedef typename A::T T;
  auto kernel = ring_attention_kernel<A>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long tiles = (long long)G.bh * (G.zigzag ? 2 : 1) *
                          cdiv(G.zigzag ? G.s_loc / 2 : G.s_loc, A::ROWS);
  // world 1 spins on nothing: one block a tile; a ring rank is persistent
  const long long grid = G.world == 1 ? tiles : (tiles < max_blocks ? tiles : max_blocks);
  if (grid < 1 || grid > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(grid), A::THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), static_cast<float*>(m_st),
      static_cast<float*>(l_st), static_cast<float*>(acc_st), static_cast<const T*>(land_me),
      static_cast<T*>(land_right), G, r, arg);
  return cudaSuccess;
}

int pow2_at_least(int d, int lo) {
  int p = lo;
  while (p < d) p <<= 1;
  return p;
}

}  // namespace

// K35. q, k, v, out [bh, s_loc, d] in one type (bf16: d <= 128; f32: d <=
// 256), lse f32 [bh, s_loc]; m_state, l_state f32 [bh, s_loc] and
// acc_state f32 [bh, s_loc, d] this rank's scratch (world > 1); land_me /
// land_right this rank's and its right neighbour's landing buffer [world -
// 1][2][bh, s_loc, d]; the ring's flags as ring.cu's kernels take them
// (world > 1; null at world 1). zigzag needs an even s_loc.
extern "C" int tdt_ring_attention(const void* q, const void* k, const void* v, void* out,
                                  void* lse, void* m_state, void* l_state, void* acc_state,
                                  const void* land_me, void* land_right, int bh, int s_loc,
                                  int d, int dtype, int causal, int zigzag, float scale,
                                  int world, int me, void* entry_wait, void* entry_signal,
                                  void* flags_me, void* flags_right, void* count, int epoch,
                                  int max_blocks, int jitter, void* diag, long long timeout_ns,
                                  int family, void* stream) {
  if (bh < 1 || s_loc < 1 || d < 1 || (zigzag && s_loc % 2) || world < 1 ||
      world > shmem::RING_MAX_WORLD || me < 0 || me >= world)
    return static_cast<int>(cudaErrorInvalidValue);
  Ring r = {};
  if (world > 1 && !shmem::make_ring(world, me, epoch, entry_wait, entry_signal, flags_me,
                                     flags_right, count, jitter, diag, timeout_ns, family, r))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo G{bh, s_loc, d, world, me, zigzag, causal, scale, (long long)bh * s_loc * d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kF32 && d <= 256) {
    const int dp = pow2_at_least(d, 4);
    err = launch<Fma>(q, k, v, out, lse, m_state, l_state, acc_state, land_me, land_right, G, r,
                      max_blocks, dp, Fma::smem_bytes(dp), s);
  } else if (dtype == kBF16 && d <= 128) {
    const int vec = (d % 8 == 0) && (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(k) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(v) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(land_me) % 16 == 0);
    if (d <= 64)
      err = launch<Mma<64>>(q, k, v, out, lse, m_state, l_state, acc_state, land_me, land_right,
                            G, r, max_blocks, vec, Mma<64>::SMEM, s);
    else
      err = launch<Mma<128>>(q, k, v, out, lse, m_state, l_state, acc_state, land_me,
                             land_right, G, r, max_blocks, vec, Mma<128>::SMEM, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
