// One rank's DP work of the sequence-parallel Smith-Waterman between two
// exchanges, for Hopper (sm_90a), written by hand.
//
// Replaces the per-device bodies of the JAX package's sequence-parallel SW,
// genome_assembly_tpu/parallel/seqpar.py:49 _seqpar_body (one DP row between
// an all_gather of the block totals and a ppermute of the last column) and
// :193 _seqpar_body_pipelined (R rows between two ppermutes of a (2, R, B)
// slab). Both are XLA scans under shard_map. The exchanges stay outside,
// in torch.distributed (parallel/seqpar.py); ops/seqpar.py holds the
// wrappers, the plain versions and the rule that picks the geometry
// (`plan`), which the launch entries check.
//
// What it computes, for item b and DP row i on the rank's block of Gb
// columns, global columns j = off + 1 .. off + Gb (valid while j <= g_len):
//   sub   = match if genome[c] == query[b][i-1] else mismatch  (codes, so a
//           PAD facing a PAD matches)
//   diag  = prev[c-1] + sub   (prev[-1]: the diagonal halo)
//   up    = prev[c] + indel
//   c0    = valid ? max(diag, up, 0) : 0
//   key   = c0 - indel * j;  run = cummax over the block's columns of key
//   row   = max(run, cin) + indel * j   (cin: the carry from the blocks to
//           the left; NEG in the per-row variant's first block, the
//           exchange's zero fill in the pipelined one)
//   left  = row[c-1] + indel  (row[-1]: the left halo)
//   code  = 1 if diag >= up, left, 0; else 2 if up >= left, 0; else 3 if
//           left >= 0; else 0; and 0 where row <= 0 or the column is past
//           g_len (the reference's cascade, aligners.py:122-132)
//   best  = the first strict maximum of row over the valid columns, taken
//           when it beats the running best and i <= q_len[b].
// Every column is computed, past g_len too, so that the dp rows, the last
// column and the carry equal the JAX bodies' bit for bit.
//
// Exact range: the wrapper (ops/seqpar.py::check_range) refuses penalties
// and lengths with max(|match|, |mismatch|, |indel|) * (n_pad + 2 Gp + 2)
// >= 2^27, so every dp value, key and carry lies well above NEG = -2^28,
// the identity of every max below. Hence the value left of any column is
// max(the keys left of it, cin) + indel * (its j - 1) exactly, at a segment
// boundary inside a rank as at a rank boundary: a segment derives both of
// its halos from the carry into it, and only that carry crosses segments.
//
// What bounds it on this card: the codes, a byte a DP cell (819 MB for 64
// queries of n_pad 256 against 50 kb on one rank), written once: 0.24 ms at
// 3.35 TB/s, against 0.12 ms for 3 int ops a valid cell on the integer
// pipes.
//
// The design, against what held the first kernel back:
// - An item's Gb columns are cut into S segments of `seg` columns, one
//   block of kThreads threads each, so that B * S blocks fill the card
//   (ops/seqpar.py::plan; S <= 8, the portable cluster size). The blocks of
//   an item form one thread block cluster (cudaLaunchKernelEx with a
//   cluster dimension of S).
// - The scan along a row: each thread takes an odd number of adjacent
//   columns (bank-conflict-free shared reads), runs the left chain in
//   registers (max(m + indel, c0), one DPX __viaddmax_s32 a cell), and the
//   chunk totals join by a warp-shuffle scan and one array of warp totals
//   (one barrier). A second pass over the chunk writes the row, its codes
//   and the thread's first strict maximum.
// - Pipelined step (seqpar_step_kernel): a segment's dp row and genome
//   codes are loaded into shared memory once (cp.async, 16 bytes a thread),
//   stay there for all R rows of the step, and are written back once. A
//   row is one pass over the segment: each block publishes its segment's
//   key total of the row into the shared memory of the blocks to its right
//   (distributed shared memory, one tagged 64-bit word a row) and folds the
//   totals of the blocks to its left as they arrive (polling its own
//   slots) into its carry: blocks run the row together, skewed only by
//   that look-back, so a step costs R + S - 1 hops, not R * tiles phases.
//   A segment wider than a block's shared memory holds (seg >
//   kMaxResident) walks its columns in tiles through global memory twice a
//   row instead (the totals, then the row), the next tile's load in flight
//   while one is scanned; that path is exact too.
// - Per-row variant: *pre* (seqpar_row_pre_kernel) scans the segments in
//   tiles and writes each segment's total at the segment's last column of
//   `run` (the only words of `run` it writes) and the rank's total, folded
//   across the cluster, for the all-gather; *post* (seqpar_row_post_kernel)
//   folds the gathered totals and the totals of the segments to its left
//   into its carry, recomputes the key scan from the old row (3 int ops a
//   cell instead of 8 bytes a cell through L2) and emits. The blocks of an
//   item only meet twice: a cluster barrier between reading the old value
//   left of each segment and rewriting the row, and the fold of the best.
// - Codes are staged in shared memory and stored 16 bytes a thread (the
//   ragged ends of a row byte by byte); dp rows likewise.
// - The best: a thread searches its chunk for the first column of its
//   maximum only when that maximum beats the running best; the block folds
//   (value, column) by the greatest value, then the smallest column
//   (shuffles, then warp totals); the segments' candidates are folded the
//   same way, with the row before the column in the pipelined step, by
//   block 0 of the cluster, never by the order in which blocks arrive;
//   then the strict > against the running best.

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileChunk = 15;              // columns a thread, streamed
constexpr int kTile = kThreads * kTileChunk;
constexpr int kMaxChunk = 63;               // columns a thread, resident
constexpr int kMaxResident = kThreads * kMaxChunk;
constexpr int kMaxCluster = 8;
constexpr int kRing = 16;                   // rows between cluster barriers
constexpr int kStepBlocksAnSm = 4;          // the step kernel's registers
constexpr int kNeg = -(1 << 28);

struct Penalties {
  int match, mismatch, indel;
};

struct Geo {
  const int8_t* queries;
  long long q_stride;
  const int* q_len;
  const int8_t* genome;
  int gb, off, g_len, seg;
};

struct Shared {
  unsigned long long slot[kRing][kMaxCluster];  // (row + 1, total) a block
  int warp_tot[2][kWarps];
  int warp_val[kWarps], warp_col[kWarps];
  int cand_val[kMaxCluster], cand_row[kMaxCluster], cand_col[kMaxCluster];
  int cin, best, best_col;
};

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }
// a region of shared memory that holds n words (or bytes) of global memory
// at the same address mod 16
__host__ __device__ constexpr int word_region(int n) {
  return align16(4 * n + 16);
}
__host__ __device__ constexpr int byte_region(int n) {
  return align16(n + 16);
}
__host__ __device__ constexpr int resident_smem(int n) {
  return word_region(n) + 2 * byte_region(n);
}
constexpr int kStreamSmem =
    2 * (word_region(kTile) + byte_region(kTile)) + byte_region(kTile);

template <typename T>
__device__ __forceinline__ T* staged(char* region, const void* global) {
  return reinterpret_cast<T*>(region +
                              (reinterpret_cast<uintptr_t>(global) & 15));
}

// ---------------------------------------------------------------------------
// copies between global and shared memory, 16 bytes a thread
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int head_bytes(const void* p, int n) {
  return min(n, static_cast<int>(
                    (16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15));
}

// n bytes of global memory into shared memory that lies at the same address
// mod 16: cp.async for the aligned body, byte loads for the ragged ends.
// Not waited for.
__device__ void load_async(void* dst_, const void* src_, int n) {
  char* dst = static_cast<char*>(dst_);
  const char* src = static_cast<const char*>(src_);
  const int head = head_bytes(src, n);
  const int end = head + ((n - head) & ~15);
  for (int k = threadIdx.x; k < head; k += kThreads) dst[k] = src[k];
  for (int k = head + threadIdx.x * 16; k < end; k += kThreads * 16)
    cp_async16(dst + k, src + k);
  for (int k = end + threadIdx.x; k < n; k += kThreads) dst[k] = src[k];
}

// n bytes of shared memory to global memory at the same address mod 16.
__device__ void store16(void* dst_, const void* src_, int n) {
  char* dst = static_cast<char*>(dst_);
  const char* src = static_cast<const char*>(src_);
  const int head = head_bytes(dst, n);
  const int end = head + ((n - head) & ~15);
  for (int k = threadIdx.x; k < head; k += kThreads) dst[k] = src[k];
  for (int k = head + threadIdx.x * 16; k < end; k += kThreads * 16)
    *reinterpret_cast<int4*>(dst + k) =
        *reinterpret_cast<const int4*>(src + k);
  for (int k = end + threadIdx.x; k < n; k += kThreads) dst[k] = src[k];
}

// ---------------------------------------------------------------------------
// distributed shared memory and cluster barriers
// ---------------------------------------------------------------------------

// A slot holds (tag, value) in one 64-bit word, written and read whole, so
// a reader that sees the tag sees the value: relaxed ordering suffices.
__device__ __forceinline__ void st_relaxed_cluster(unsigned long long* p,
                                                   unsigned long long v) {
  asm volatile("st.relaxed.cluster.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed_cluster(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.cluster.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Thread 0: publishes this block's key total of row r to the blocks to its
// right and folds the totals of the blocks to its left into cin0, waiting
// for each. Slots are tagged r + 1; a ring of kRing rows, which the caller
// keeps from wrapping with a cluster barrier every kRing rows.
__device__ int exchange(cg::cluster_group& cluster, Shared& sh, int s, int S,
                        int r, int total, int cin0) {
  const unsigned long long v =
      (static_cast<unsigned long long>(r + 1) << 32) |
      static_cast<unsigned>(total);
  for (int t = s + 1; t < S; ++t)
    st_relaxed_cluster(cluster.map_shared_rank(&sh.slot[r % kRing][s], t), v);
  int cin = cin0;
  for (int k = 0; k < s; ++k) {
    unsigned long long w;
    do {
      w = ld_relaxed_cluster(&sh.slot[r % kRing][k]);
    } while (static_cast<int>(w >> 32) != r + 1);
    cin = max(cin, static_cast<int>(static_cast<unsigned>(w)));
  }
  return cin;
}

// ---------------------------------------------------------------------------
// a thread's chunk of a row: columns k0 .. k1 - 1 of a buffer whose column k
// is global column j0 + k
// ---------------------------------------------------------------------------

// The key total of the chunk: the left chain max(m + indel, c0) from its
// first column, at its last column, minus indel * j there. `pl`: the old dp
// value left of the chunk.
template <bool kAllValid>
__device__ __forceinline__ int chunk_key(const int* dp, const int8_t* gen,
                                         int k0, int k1, int j0, int g_len,
                                         int qc, Penalties p, int pl) {
  int m = kNeg;
  for (int k = k0; k < k1; ++k) {
    const int pk = dp[k];
    const int sub = gen[k] == qc ? p.match : p.mismatch;
    int c0 = __viaddmax_s32_relu(pl, sub, pk + p.indel);
    if (!kAllValid && j0 + k > g_len) c0 = 0;
    m = __viaddmax_s32(m, p.indel, c0);
    pl = pk;
  }
  return m - p.indel * (j0 + k1 - 1);
}

__device__ __forceinline__ int cascade(int diag, int up, int left) {
  if (diag >= up && diag >= left && diag >= 0) return 1;
  if (up >= left && up >= 0) return 2;
  return left >= 0 ? 3 : 0;
}

// The chunk's row over its old values in place and its codes into `stage`;
// returns its maximum over the valid columns (-1: none). `m`: the new value
// left of the chunk, max(the keys left of it, cin) + indel * (j - 1);
// `left0`: the left move of its first column. The first column takes the
// reference's cascade; at every other one row = max(diag, up, left, 0), so
// the cascade is 1 where diag == row, else 2 where up == row, else 3.
template <bool kAllValid>
__device__ __forceinline__ int emit_chunk(int* dp, const int8_t* gen,
                                          uint8_t* stage, int k0, int k1,
                                          int j0, int g_len, int qc,
                                          Penalties p, int pl, int m,
                                          int left0) {
  int tmax = -1;
  {
    const int pk = dp[k0];
    const int sub = gen[k0] == qc ? p.match : p.mismatch;
    const int diag = pl + sub, up = pk + p.indel;
    const bool valid = kAllValid || j0 + k0 <= g_len;
    const int c0 = valid ? __vimax_s32_relu(diag, up) : 0;
    const int row = __viaddmax_s32(m, p.indel, c0);
    dp[k0] = row;
    stage[k0] = row > 0 && valid ? cascade(diag, up, left0) : 0;
    if (valid) tmax = row;
    pl = pk;
    m = row;
  }
  for (int k = k0 + 1; k < k1; ++k) {
    const int pk = dp[k];
    const int sub = gen[k] == qc ? p.match : p.mismatch;
    const int diag = pl + sub, up = pk + p.indel;
    const bool valid = kAllValid || j0 + k <= g_len;
    const int c0 = valid ? __vimax_s32_relu(diag, up) : 0;
    const int row = __viaddmax_s32(m, p.indel, c0);
    const int code = diag == row ? 1 : (up == row ? 2 : 3);
    dp[k] = row;
    stage[k] = row > 0 && valid ? code : 0;
    if (valid) tmax = max(tmax, row);
    pl = pk;
    m = row;
  }
  return tmax;
}

template <bool kAllValid>
__device__ __forceinline__ int first_col(const int* dp, int k0, int k1,
                                         int j0, int g_len, int v) {
  for (int k = k0; k < k1; ++k)
    if ((kAllValid || j0 + k <= g_len) && dp[k] == v) return k;
  return k1;
}

// The two passes and the search, each taking the tile's validity once.
struct Chunk {
  int k0, k1, j0, g_len, qc;
  Penalties p;
  bool all_valid;

  __device__ int key(const int* dp, const int8_t* gen, int pl) const {
    return all_valid ? chunk_key<true>(dp, gen, k0, k1, j0, g_len, qc, p, pl)
                     : chunk_key<false>(dp, gen, k0, k1, j0, g_len, qc, p,
                                        pl);
  }
  __device__ int emit(int* dp, const int8_t* gen, uint8_t* stage, int pl,
                      int m, int left0) const {
    return all_valid ? emit_chunk<true>(dp, gen, stage, k0, k1, j0, g_len,
                                        qc, p, pl, m, left0)
                     : emit_chunk<false>(dp, gen, stage, k0, k1, j0, g_len,
                                         qc, p, pl, m, left0);
  }
  __device__ int first(const int* dp, int v) const {
    return all_valid ? first_col<true>(dp, k0, k1, j0, g_len, v)
                     : first_col<false>(dp, k0, k1, j0, g_len, v);
  }
};

// ---------------------------------------------------------------------------
// block-wide folds
// ---------------------------------------------------------------------------

// The exclusive max scan of the threads' chunk keys in thread order (kNeg
// for thread 0) and, through `total`, their max. One barrier; the two warp
// total arrays alternate (`parity`), so the next call needs none before it.
__device__ __forceinline__ int block_scan(int key, int& total, Shared& sh,
                                          int& parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = key;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl = max(incl, o);
  }
  if (lane == 31) sh.warp_tot[parity][warp] = incl;
  __syncthreads();
  int w = lane < kWarps ? sh.warp_tot[parity][lane] : kNeg;
  parity ^= 1;
#pragma unroll
  for (int d = 1; d < kWarps; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, w, d);
    if (lane >= d) w = max(w, o);
  }
  total = __shfl_sync(0xffffffffu, w, kWarps - 1);
  const int before = __shfl_sync(0xffffffffu, w, warp > 0 ? warp - 1 : 0);
  int excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = kNeg;
  return warp > 0 ? max(excl, before) : excl;
}

__device__ __forceinline__ bool better(int v, int c, int bv, int bc) {
  return v > bv || (v == bv && c < bc);
}

// The block's first strict maximum from every thread's (value, column): the
// greatest value, then the smallest column; every thread gets it.
__device__ void block_best(int& val, int& col, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int ov = __shfl_down_sync(0xffffffffu, val, d);
    const int oc = __shfl_down_sync(0xffffffffu, col, d);
    if (better(ov, oc, val, col)) {
      val = ov;
      col = oc;
    }
  }
  if (lane == 0) {
    sh.warp_val[warp] = val;
    sh.warp_col[warp] = col;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w)
      if (better(sh.warp_val[w], sh.warp_col[w], val, col)) {
        val = sh.warp_val[w];
        col = sh.warp_col[w];
      }
    sh.best = val;
    sh.best_col = col;
  }
  __syncthreads();
  val = sh.best;
  col = sh.best_col;
}

// ---------------------------------------------------------------------------
// a segment's row walked in tiles through global memory
// ---------------------------------------------------------------------------

// Two tiles of (dp words, genome bytes) and one code staging region, in
// that order; offsets, not an array, so nothing lands on the stack.
constexpr int kTileBytes = word_region(kTile) + byte_region(kTile);

struct Stream {
  char* base;
  __device__ char* dp(int buf) const { return base + buf * kTileBytes; }
  __device__ char* gen(int buf) const {
    return base + buf * kTileBytes + word_region(kTile);
  }
  __device__ char* stage() const { return base + 2 * kTileBytes; }
};

__device__ __forceinline__ void issue_tile(const Stream& st, int buf,
                                           const int* prev_row,
                                           const int8_t* genome, int c,
                                           int n) {
  load_async(staged<int>(st.dp(buf), prev_row + c), prev_row + c, 4 * n);
  load_async(staged<int8_t>(st.gen(buf), genome + c), genome + c, n);
  cp_async_commit();
}

struct SegRow {        // one row of one segment
  int c0, n;           // the segment's first column in the block, width
  int jbase;           // global column of block column 0 (off + 1)
  int g_len, qc;
  Penalties p;
};

__device__ __forceinline__ Chunk tile_chunk(const SegRow& r, int c, int n) {
  const int k0 = min(static_cast<int>(threadIdx.x) * kTileChunk, n);
  return Chunk{k0, min(k0 + kTileChunk, n), r.jbase + c, r.g_len, r.qc, r.p,
               r.jbase + c + n - 1 <= r.g_len};
}

// The segment's key total of the row. `halo_diag`: the old value left of
// the segment.
__device__ int sweep_totals(const Stream& st, Shared& sh, int& parity,
                            const int* prev_row, const int8_t* genome,
                            const SegRow& r, int halo_diag) {
  const int nt = (r.n + kTile - 1) / kTile;
  int total = kNeg, left_old = halo_diag;
  __syncthreads();  // the buffers are free
  issue_tile(st, 0, prev_row, genome, r.c0, min(kTile, r.n));
  for (int t = 0; t < nt; ++t) {
    const int c = r.c0 + t * kTile, n = min(kTile, r.n - t * kTile);
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < nt)
      issue_tile(st, (t + 1) & 1, prev_row, genome, c + kTile,
                 min(kTile, r.n - (t + 1) * kTile));
    const int* dp = staged<int>(st.dp(t & 1), prev_row + c);
    const int8_t* gen = staged<int8_t>(st.gen(t & 1), genome + c);
    const Chunk ch = tile_chunk(r, c, n);
    int key = kNeg;
    if (ch.k0 < ch.k1) key = ch.key(dp, gen, ch.k0 ? dp[ch.k0 - 1] : left_old);
    if (threadIdx.x == 0) left_old = dp[n - 1];
    int tile_total;
    block_scan(key, tile_total, sh, parity);
    total = max(total, tile_total);
  }
  return total;
}

// The segment's row, in place in prev_row, its codes into code_row (both
// indexed by block column), and each thread's first strict maximum above
// bval (when `track`). `left0`: the left move of the segment's first
// column. Returns the segment's key total.
__device__ int sweep_row(const Stream& st, Shared& sh, int& parity,
                         int* prev_row, const int8_t* genome,
                         uint8_t* code_row, const SegRow& r, int halo_diag,
                         int left0, int cin, bool track, int& bval,
                         int& bcol) {
  const int nt = (r.n + kTile - 1) / kTile;
  int carry = kNeg, left_old = halo_diag;
  __syncthreads();
  issue_tile(st, 0, prev_row, genome, r.c0, min(kTile, r.n));
  for (int t = 0; t < nt; ++t) {
    const int c = r.c0 + t * kTile, n = min(kTile, r.n - t * kTile);
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < nt)
      issue_tile(st, (t + 1) & 1, prev_row, genome, c + kTile,
                 min(kTile, r.n - (t + 1) * kTile));
    int* dp = staged<int>(st.dp(t & 1), prev_row + c);
    const int8_t* gen = staged<int8_t>(st.gen(t & 1), genome + c);
    uint8_t* stage = staged<uint8_t>(st.stage(), code_row + c);
    const Chunk ch = tile_chunk(r, c, n);
    int key = kNeg, pl = 0;
    if (ch.k0 < ch.k1) {
      pl = ch.k0 ? dp[ch.k0 - 1] : left_old;
      key = ch.key(dp, gen, pl);
    }
    if (threadIdx.x == 0) left_old = dp[n - 1];
    int tile_total;
    const int excl = block_scan(key, tile_total, sh, parity);
    if (ch.k0 < ch.k1) {
      const int m =
          max(max(excl, carry), cin) + r.p.indel * (ch.j0 + ch.k0 - 1);
      const int tmax = ch.emit(dp, gen, stage, pl, m,
                               t == 0 && ch.k0 == 0 ? left0 : m + r.p.indel);
      if (track && tmax > bval) {
        bval = tmax;
        bcol = c + ch.first(dp, tmax);
      }
    }
    carry = max(carry, tile_total);
    __syncthreads();
    store16(prev_row + c, dp, 4 * n);
    store16(code_row + c, stage, n);
  }
  return carry;
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

struct Block {          // what a block of the cluster takes
  int S, s, b, c0, n;
};

__device__ __forceinline__ Block this_block(cg::cluster_group& cluster,
                                            const Geo& g) {
  Block k;
  k.S = static_cast<int>(cluster.num_blocks());
  k.s = static_cast<int>(cluster.block_rank());
  k.b = blockIdx.x / k.S;
  k.c0 = k.s * g.seg;
  k.n = min(g.seg, g.gb - k.c0);
  return k;
}

// Rows row1 .. row1 + R - 1 of item b's segment s: resident in shared
// memory (kResident), else tiled through global memory.
template <bool kResident>
__global__ void __launch_bounds__(kThreads, kStepBlocksAnSm)
seqpar_step_kernel(Geo g, int B, int row1, int R, int* prev,
                   const int* halo_diag0, const int* slab_in, int* slab_out,
                   uint8_t* codes, int* best_out, int* bi_out, int* bj_out,
                   Penalties p) {
  extern __shared__ __align__(16) char dyn[];
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const Block k = this_block(cluster, g);
  const int b = k.b, s = k.s, S = k.S;
  const int jseg = g.off + 1 + k.c0;  // global column of the segment's first
  int* prev_row = prev + static_cast<long long>(b) * g.gb;
  const int q_len = g.q_len[b];
  for (int t = threadIdx.x; t < kRing * kMaxCluster; t += kThreads)
    (&sh.slot[0][0])[t] = 0ull;
  // the old value left of the segment, read before any block rewrites it
  int diag_halo = s == 0 ? halo_diag0[b] : prev_row[k.c0 - 1];
  const int best0 = best_out[b];
  int seg_val = best0, seg_row = INT_MAX, seg_col = INT_MAX;
  int parity = 0;
  int* rdp = nullptr;
  int8_t* rgen = nullptr;
  Stream st{dyn};
  if (kResident) {
    rdp = staged<int>(dyn, prev_row + k.c0);
    rgen = staged<int8_t>(dyn + word_region(g.seg), g.genome + k.c0);
    load_async(rdp, prev_row + k.c0, 4 * k.n);
    load_async(rgen, g.genome + k.c0, k.n);
    cp_async_commit();
    cp_async_wait_all();
  }
  char* rstage = dyn + word_region(g.seg) + byte_region(g.seg);
  const int cn = ((k.n + kThreads - 1) / kThreads) | 1;
  const int rk0 = min(static_cast<int>(threadIdx.x) * cn, k.n);
  const Chunk rch{rk0, min(rk0 + cn, k.n), jseg, g.g_len, 0, p,
                  jseg + k.n - 1 <= g.g_len};
  cluster.sync();  // every block has read its halo and cleared its slots
  for (int r = 0; r < R; ++r) {
    const int i = row1 + r;
    const int qc = g.queries[b * g.q_stride + (i - 1)];
    const int slab_cin = slab_in[(R + r) * B + b];
    uint8_t* code_row =
        codes + (static_cast<long long>(i - 1) * B + b) * g.gb;
    const bool track = i <= q_len;
    int bval = seg_val, bcol = INT_MAX;
    int total, cin;
    if constexpr (kResident) {
      Chunk ch = rch;
      ch.qc = qc;
      int key = kNeg, pl = 0;
      if (ch.k0 < ch.k1) {
        pl = ch.k0 ? rdp[ch.k0 - 1] : diag_halo;
        key = ch.key(rdp, rgen, pl);
      }
      const int excl = block_scan(key, total, sh, parity);
      if (threadIdx.x == 0)
        sh.cin = exchange(cluster, sh, s, S, r, total, slab_cin);
      __syncthreads();
      cin = sh.cin;
      const int halo_left =
          s == 0 ? slab_in[r * B + b] : cin + p.indel * (jseg - 1);
      uint8_t* stage = staged<uint8_t>(rstage, code_row + k.c0);
      if (ch.k0 < ch.k1) {
        const int m = max(excl, cin) + p.indel * (jseg + ch.k0 - 1);
        const int tmax = ch.emit(rdp, rgen, stage, pl, m,
                                 (ch.k0 ? m : halo_left) + p.indel);
        if (track && tmax > bval) {
          bval = tmax;
          bcol = k.c0 + ch.first(rdp, tmax);
        }
      }
      __syncthreads();
      store16(code_row + k.c0, stage, k.n);
      diag_halo = halo_left;
    } else {
      const SegRow sr{k.c0, k.n, g.off + 1, g.g_len, qc, p};
      total = sweep_totals(st, sh, parity, prev_row, g.genome, sr, diag_halo);
      if (threadIdx.x == 0)
        sh.cin = exchange(cluster, sh, s, S, r, total, slab_cin);
      __syncthreads();
      cin = sh.cin;
      const int halo_left =
          s == 0 ? slab_in[r * B + b] : cin + p.indel * (jseg - 1);
      sweep_row(st, sh, parity, prev_row, g.genome, code_row, sr, diag_halo,
                halo_left + p.indel, cin, track, bval, bcol);
      diag_halo = halo_left;
    }
    if (s == S - 1 && threadIdx.x == 0) {
      const int carry = max(cin, total);
      slab_out[(R + r) * B + b] = carry;
      slab_out[r * B + b] = carry + p.indel * (g.off + g.gb);
    }
    if (track && __syncthreads_or(bval > seg_val)) {
      block_best(bval, bcol, sh);
      seg_val = bval;
      seg_row = i;
      seg_col = bcol;
    }
    if ((r + 1) % kRing == 0 && r + 1 < R) cluster.sync();
  }
  if (kResident) {
    __syncthreads();
    store16(prev_row + k.c0, rdp, 4 * k.n);
  }
  if (threadIdx.x == 0) {
    Shared* lead = cluster.map_shared_rank(&sh, 0);
    lead->cand_val[s] = seg_val;
    lead->cand_row[s] = seg_row;
    lead->cand_col[s] = seg_col;
  }
  cluster.sync();
  if (s == 0 && threadIdx.x == 0) {
    // (greatest value, then earliest row, then smallest column)
    int v = best0, row = INT_MAX, col = INT_MAX;
    for (int t = 0; t < S; ++t) {
      const int ov = sh.cand_val[t], orow = sh.cand_row[t],
                oc = sh.cand_col[t];
      if (ov > v || (ov == v && (orow < row || (orow == row && oc < col)))) {
        v = ov;
        row = orow;
        col = oc;
      }
    }
    if (v > best0) {
      best_out[b] = v;
      bi_out[b] = row;
      bj_out[b] = g.off + 1 + col;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
seqpar_row_pre_kernel(Geo g, int i, const int* prev, const int* halo_diag,
                      int* run, int* total_out, Penalties p) {
  extern __shared__ __align__(16) char dyn[];
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const Block k = this_block(cluster, g);
  const int* prev_row = prev + static_cast<long long>(k.b) * g.gb;
  const int diag_halo = k.s == 0 ? halo_diag[k.b] : prev_row[k.c0 - 1];
  const SegRow sr{k.c0, k.n, g.off + 1, g.g_len,
                  g.queries[k.b * g.q_stride + (i - 1)], p};
  int parity = 0;
  const int total = sweep_totals(Stream{dyn}, sh, parity, prev_row,
                                 g.genome, sr, diag_halo);
  if (threadIdx.x == 0) {
    run[static_cast<long long>(k.b) * g.gb + k.c0 + k.n - 1] = total;
    cluster.map_shared_rank(&sh, 0)->cand_val[k.s] = total;
  }
  cluster.sync();
  if (k.s == 0 && threadIdx.x == 0) {
    int t = kNeg;
    for (int u = 0; u < k.S; ++u) t = max(t, sh.cand_val[u]);
    total_out[k.b] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
seqpar_row_post_kernel(Geo g, int B, int i, int* prev, const int* halo_diag,
                       const int* run, const int* totals, int index,
                       uint8_t* code_rows, int* last_out, int* best_out,
                       int* bi_out, int* bj_out, Penalties p) {
  extern __shared__ __align__(16) char dyn[];
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const Block k = this_block(cluster, g);
  const long long row_off = static_cast<long long>(k.b) * g.gb;
  int* prev_row = prev + row_off;
  const int diag_halo = k.s == 0 ? halo_diag[k.b] : prev_row[k.c0 - 1];
  // the block to the left rewrites that value only after this arrival
  cluster_arrive();
  int cin_rank = kNeg;
  for (int d = 0; d < index; ++d)
    cin_rank = max(cin_rank, totals[d * B + k.b]);
  int cin = cin_rank;
  for (int u = 0; u < k.s; ++u)
    cin = max(cin, run[row_off + (u + 1) * g.seg - 1]);
  const int halo_left =
      k.s > 0 ? cin + p.indel * (g.off + k.c0)
              : (index == 0 ? 0 : cin_rank + p.indel * g.off);
  const int best0 = best_out[k.b];
  const bool track = i <= g.q_len[k.b];
  const SegRow sr{k.c0, k.n, g.off + 1, g.g_len,
                  g.queries[k.b * g.q_stride + (i - 1)], p};
  int parity = 0, bval = best0, bcol = INT_MAX;
  cluster_wait();
  const int carry = sweep_row(Stream{dyn}, sh, parity, prev_row,
                              g.genome, code_rows + row_off, sr, diag_halo,
                              halo_left + p.indel, cin, track, bval, bcol);
  if (k.s == k.S - 1 && threadIdx.x == 0)
    last_out[k.b] = max(cin, carry) + p.indel * (g.off + g.gb);
  if (track && __syncthreads_or(bval > best0)) block_best(bval, bcol, sh);
  if (threadIdx.x == 0) {
    Shared* lead = cluster.map_shared_rank(&sh, 0);
    lead->cand_val[k.s] = bval;
    lead->cand_col[k.s] = bcol;
  }
  cluster.sync();
  if (k.s == 0 && threadIdx.x == 0) {
    int v = best0, col = INT_MAX;
    for (int u = 0; u < k.S; ++u)
      if (better(sh.cand_val[u], sh.cand_col[u], v, col)) {
        v = sh.cand_val[u];
        col = sh.cand_col[u];
      }
    if (v > best0) {
      best_out[k.b] = v;
      bi_out[k.b] = i;
      bj_out[k.b] = g.off + 1 + col;
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

Geo make_geo(const void* queries, long long q_stride, const void* q_len,
             const void* genome, int gb, int off, int g_len, int seg) {
  return Geo{static_cast<const int8_t*>(queries), q_stride,
             static_cast<const int*>(q_len),
             static_cast<const int8_t*>(genome), gb, off, g_len, seg};
}

// S segments of seg columns cover gb exactly, none empty.
bool valid_geometry(int gb, int S, int seg, int resident) {
  return gb > 0 && S >= 1 && S <= kMaxCluster && seg >= 1 &&
         static_cast<long long>(S) * seg >= gb &&
         static_cast<long long>(S - 1) * seg < gb &&
         (!resident || seg <= kMaxResident);
}

int smem_bytes(int resident, int seg) {
  return resident ? resident_smem(seg) : kStreamSmem;
}

constexpr int kMaxDevices = 64;

// Launches kKernel in clusters of S blocks. A kernel that takes more than
// 48 KB of dynamic shared memory is allowed the most it can ever take,
// once a device.
template <auto kKernel, typename... Args>
cudaError_t launch(int device, int blocks, int S, int smem, void* stream,
                   Args... args) {
  static bool allowed[kMaxDevices] = {};
  if (smem > 48 * 1024 && !(device < kMaxDevices && allowed[device])) {
    cudaError_t err = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        resident_smem(kMaxResident));
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) allowed[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kKernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernel's constants, for the wrapper to check against its copy:
// threads, columns a thread streamed and resident, the largest cluster, the
// ring of rows, shared memory of a streamed block and of the widest
// resident segment.
int seqpar_constants(int* out) {
  out[0] = kThreads;
  out[1] = kTileChunk;
  out[2] = kMaxChunk;
  out[3] = kMaxCluster;
  out[4] = kRing;
  out[5] = kStreamSmem;
  out[6] = resident_smem(kMaxResident);
  return 0;
}

// How many clusters of S blocks of one kernel (0 step, 1 pre, 2 post) with
// that geometry's shared memory fit on `device` at once (cudaOccupancy-
// MaxActiveClusters); returns a cudaError_t.
int seqpar_max_active_clusters(int kind, int S, int resident, int seg,
                               int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = smem_bytes(resident, seg);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * 64);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const void* kernels[3] = {
      resident ? reinterpret_cast<const void*>(seqpar_step_kernel<true>)
               : reinterpret_cast<const void*>(seqpar_step_kernel<false>),
      reinterpret_cast<const void*>(seqpar_row_pre_kernel),
      reinterpret_cast<const void*>(seqpar_row_post_kernel)};
  if (kind < 0 || kind > 2) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // as launch() allows it
    err = cudaFuncSetAttribute(kernels[kind],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               resident_smem(kMaxResident));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, kernels[kind], &cfg));
}

// Each entry launches one kernel of B * S blocks, in clusters of S, on
// `stream` (a cudaStream_t) of `device`, not synchronised, and returns a
// cudaError_t as an int (0 = launched). The caller (ops/seqpar.py) picks
// the geometry (S segments of seg columns; `resident`) and checks shapes,
// types, contiguity, the rows' range and the exact range of the scores.
// Rows are 1-based.

// The pipelined variant's step: rows row1 .. row1 + R - 1.
int seqpar_step_launch(const void* queries, long long q_stride,
                       const void* q_len, const void* genome, int gb, int off,
                       int g_len, int B, int row1, int R, int S, int seg,
                       int resident, void* prev, const void* halo_diag0,
                       const void* slab_in, void* slab_out, void* codes,
                       void* best, void* bi, void* bj, int match,
                       int mismatch, int indel, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || R <= 0) return 0;
  if (row1 < 1 || !valid_geometry(gb, S, seg, resident))
    return cudaErrorInvalidValue;
  const Geo g = make_geo(queries, q_stride, q_len, genome, gb, off, g_len,
                         seg);
  const Penalties p{match, mismatch, indel};
  auto* codes8 = static_cast<uint8_t*>(codes);
  auto* prev32 = static_cast<int*>(prev);
  auto* halo32 = static_cast<const int*>(halo_diag0);
  auto* in32 = static_cast<const int*>(slab_in);
  auto* out32 = static_cast<int*>(slab_out);
  auto *best32 = static_cast<int*>(best), *bi32 = static_cast<int*>(bi),
       *bj32 = static_cast<int*>(bj);
  return static_cast<int>(
      resident
          ? launch<seqpar_step_kernel<true>>(
                device, B * S, S, smem_bytes(1, seg), stream, g, B, row1, R,
                prev32, halo32, in32, out32, codes8, best32, bi32, bj32, p)
          : launch<seqpar_step_kernel<false>>(
                device, B * S, S, smem_bytes(0, seg), stream, g, B, row1, R,
                prev32, halo32, in32, out32, codes8, best32, bi32, bj32,
                p));
}

// The per-row variant's first half of row i: each segment's key total at
// its last column of `run` (B, Gb), nothing else of it, and the rank's
// totals `total` (B,). q_len is not read.
int seqpar_row_pre_launch(const void* queries, long long q_stride,
                          const void* q_len, const void* genome, int gb,
                          int off, int g_len, int B, int i, int S, int seg,
                          const void* prev, const void* halo_diag, void* run,
                          void* total, int match, int mismatch, int indel,
                          void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  if (i < 1 || !valid_geometry(gb, S, seg, 0)) return cudaErrorInvalidValue;
  return static_cast<int>(launch<seqpar_row_pre_kernel>(
      device, B * S, S, kStreamSmem, stream,
      make_geo(queries, q_stride, q_len, genome, gb, off, g_len, seg), i,
      static_cast<const int*>(prev), static_cast<const int*>(halo_diag),
      static_cast<int*>(run), static_cast<int*>(total),
      Penalties{match, mismatch, indel}));
}

// The per-row variant's second half of row i: the (D, B) totals folded
// left of `index` and the segment totals that *pre* left in `run`, the row
// into `prev`, its codes into `code_rows` (B, Gb), its last column into
// `last` (B,), the best fold.
int seqpar_row_post_launch(const void* queries, long long q_stride,
                           const void* q_len, const void* genome, int gb,
                           int off, int g_len, int B, int i, int S, int seg,
                           void* prev, const void* halo_diag, const void* run,
                           const void* totals, int D, int index,
                           void* code_rows, void* last, void* best, void* bi,
                           void* bj, int match, int mismatch, int indel,
                           void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  if (i < 1 || index < 0 || index >= D || !valid_geometry(gb, S, seg, 0))
    return cudaErrorInvalidValue;
  return static_cast<int>(launch<seqpar_row_post_kernel>(
      device, B * S, S, kStreamSmem, stream,
      make_geo(queries, q_stride, q_len, genome, gb, off, g_len, seg), B, i,
      static_cast<int*>(prev), static_cast<const int*>(halo_diag),
      static_cast<const int*>(run), static_cast<const int*>(totals), index,
      static_cast<uint8_t*>(code_rows), static_cast<int*>(last),
      static_cast<int*>(best), static_cast<int*>(bi), static_cast<int*>(bj),
      Penalties{match, mismatch, indel}));
}

}  // extern "C"
