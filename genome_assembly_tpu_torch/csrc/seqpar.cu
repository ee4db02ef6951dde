// One rank's DP work of the sequence-parallel Smith-Waterman between two
// exchanges, for Hopper (sm_90a), written by hand.
//
// Replaces the per-device bodies of the JAX package's sequence-parallel SW,
// genome_assembly_tpu/parallel/seqpar.py:49 _seqpar_body (one DP row between
// an all_gather of the block totals and a ppermute of the last column) and
// :193 _seqpar_body_pipelined (R rows between two ppermutes of a (2, R, B)
// slab). Both are XLA scans under shard_map. The exchanges stay outside,
// in torch.distributed (parallel/seqpar.py); ops/seqpar.py holds the
// wrappers and the plain versions.
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
// >= 2^27, so every dp value, key and carry lies well above NEG = -2^28.
//
// What bounds it on this card: the codes, a byte a DP cell (819 MB for 64
// queries of n_pad 256 against 50 kb on one rank), written once: 0.24 ms
// at 3.35 TB/s, against 0.12 ms for 3 int ops a valid cell on the integer
// pipes. This design does not reach that: it is a simple, exact first
// kernel (ROADMAP §B).
//
// The design:
// - one block of kThreads threads an item; a row is walked in tiles of
//   kTile = kThreads * kChunk columns, in order. A tile's old dp row and its
//   genome codes are loaded into shared memory, coalesced; the dp rows
//   themselves stay in global memory, where one item's 200 KB row (Gb =
//   50,000) stays in the 50 MB L2 between rows: a row does not fit in the
//   227 KB a block can take beside its tile;
// - the left chain is a max-plus prefix scan along j. Each thread scans
//   kChunk adjacent columns of the tile in registers (kChunk odd, so the
//   threads' shared-memory reads fall in distinct banks); the chunk totals
//   go through a warp scan by shuffles and one shared array of warp totals;
//   each thread folds the exclusive prefix of the threads before it and
//   the carry of the tiles before it into its chunk;
// - the row, its left neighbour's value, the cascade and the code are
//   then elementwise, thread-strided over the tile, so code bytes and dp
//   words are stored coalesced. The row overwrites the old dp row in place:
//   the tile's old values sit in shared memory, and the old and new values
//   of the tile's last column are kept for the next tile;
// - the best: each thread keeps its first strict maximum over its columns,
//   met in increasing order; the block folds them by value, then by the
//   smaller column (shuffles, then warp totals), never by thread order;
// - pipelined step: one launch runs the step's R rows, row after row (a
//   row needs the whole row above), with the halos and carries of each row
//   from the incoming slab, and writes the outgoing slab. Per-row variant:
//   *pre* scans and writes the local cummax into a scratch row and the
//   block total; *post*, after the all-gather, folds the totals of the
//   blocks left of the rank into cin, derives the left halo (cin + indel *
//   off; 0 on rank 0: ops/seqpar.py states why it is exact) and emits.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 9;
constexpr int kTile = kThreads * kChunk;
constexpr int kNeg = -(1 << 28);

struct Penalties {
  int match, mismatch, indel;
};

struct Tile {
  int prev[kTile + 1];   // old dp: [0] the column left of the tile
  int run[kTile];        // key, then its cummax over the block
  int8_t ref[kTile];     // genome codes
  int warp_max[kWarps];
  int best_val[kWarps];
  int best_col[kWarps];
};

// The old dp row and the genome codes of columns c0 .. c0 + n - 1, and the
// old dp value left of them. Ends with a barrier.
__device__ void load_tile(Tile& s, const int* prev_row, const int8_t* genome,
                          int c0, int n, int left_old) {
  for (int k = threadIdx.x; k < n; k += kThreads) {
    s.prev[k + 1] = prev_row[c0 + k];
    s.ref[k] = genome[c0 + k];
  }
  if (threadIdx.x == 0) s.prev[0] = left_old;
  __syncthreads();
}

__device__ __forceinline__ int sub_score(const Tile& s, int k, int qc,
                                         const Penalties& p) {
  return static_cast<int>(s.ref[k]) == qc ? p.match : p.mismatch;
}

// The cummax of the key over the tile into s.run, the tiles before it
// folded in through `carry`; returns the carry through the tile's last
// column. Ends with a barrier.
__device__ int scan_tile(Tile& s, int n, int j0, int g_len, int qc,
                         const Penalties& p, int carry) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = threadIdx.x * kChunk;
  int m = INT_MIN;
#pragma unroll
  for (int v = 0; v < kChunk; ++v) {
    const int k = base + v;
    if (k < n) {
      const int j = j0 + k;
      const int diag = s.prev[k] + sub_score(s, k, qc, p);
      const int up = s.prev[k + 1] + p.indel;
      const int c = j <= g_len ? max(max(diag, up), 0) : 0;
      m = max(m, c - p.indel * j);
      s.run[k] = m;
    }
  }
  int incl = m;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl = max(incl, o);
  }
  if (lane == 31) s.warp_max[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s.warp_max[lane] : INT_MIN;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = max(w, o);
    }
    if (lane < kWarps) s.warp_max[lane] = w;
  }
  __syncthreads();
  int before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = INT_MIN;
  if (warp > 0) before = max(before, s.warp_max[warp - 1]);
  before = max(before, carry);
#pragma unroll
  for (int v = 0; v < kChunk; ++v) {
    const int k = base + v;
    if (k < n) s.run[k] = max(s.run[k], before);
  }
  carry = max(carry, s.warp_max[kWarps - 1]);
  __syncthreads();
  return carry;
}

// The tile's row, codes and best candidates from s.run (the block's
// cummax), s.prev and s.ref: the row overwrites prev_row, the codes go to
// code_row. `left_new`: the new dp value left of the tile (the left halo
// at the block's first column).
__device__ void emit_tile(const Tile& s, int* prev_row, uint8_t* code_row,
                          int c0, int n, int j0, int g_len, int qc,
                          const Penalties& p, int cin, int left_new,
                          int& bval, int& bcol) {
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int j = j0 + k;
    const int row = max(s.run[k], cin) + p.indel * j;
    const int left =
        (k == 0 ? left_new : max(s.run[k - 1], cin) + p.indel * (j - 1)) +
        p.indel;
    const int diag = s.prev[k] + sub_score(s, k, qc, p);
    const int up = s.prev[k + 1] + p.indel;
    uint8_t code;
    if (diag >= up && diag >= left && diag >= 0)
      code = 1;
    else if (up >= left && up >= 0)
      code = 2;
    else if (left >= 0)
      code = 3;
    else
      code = 0;
    const bool valid = j <= g_len;
    if (!(row > 0 && valid)) code = 0;
    code_row[c0 + k] = code;
    prev_row[c0 + k] = row;
    if (valid && row > bval) {
      bval = row;
      bcol = c0 + k;
    }
  }
}

// The block's first strict maximum from every thread's (value, column):
// the greatest value, then the smallest column. Thread 0's result.
__device__ void block_best(Tile& s, int& val, int& col) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int ov = __shfl_down_sync(0xffffffffu, val, d);
    const int oc = __shfl_down_sync(0xffffffffu, col, d);
    if (ov > val || (ov == val && oc < col)) {
      val = ov;
      col = oc;
    }
  }
  if (lane == 0) {
    s.best_val[warp] = val;
    s.best_col[warp] = col;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      const int ov = s.best_val[w], oc = s.best_col[w];
      if (ov > val || (ov == val && oc < col)) {
        val = ov;
        col = oc;
      }
    }
  }
}

struct Block {
  const int8_t* queries;
  long long q_stride;
  const int* q_len;
  const int8_t* genome;
  int gb, off, g_len;
};

// One DP row of item b, scanned and emitted tile by tile; returns (through
// the references) the new dp value of the last column and the carry
// through it, and folds the row's best into (best, bi, bj) on thread 0.
__device__ void full_row(Tile& s, const Block& k, int b, int i, int* prev_row,
                         uint8_t* code_row, const Penalties& p, int halo_diag,
                         int halo_left, int cin, int& last, int& carry,
                         int& best, int& bi, int& bj) {
  const int qc = k.queries[b * k.q_stride + (i - 1)];
  int left_old = halo_diag, left_new = halo_left;
  int bval = -1, bcol = INT_MAX;
  carry = INT_MIN;
  for (int c0 = 0; c0 < k.gb; c0 += kTile) {
    const int n = min(kTile, k.gb - c0);
    const int j0 = k.off + 1 + c0;
    load_tile(s, prev_row, k.genome, c0, n, left_old);
    carry = scan_tile(s, n, j0, k.g_len, qc, p, carry);
    emit_tile(s, prev_row, code_row, c0, n, j0, k.g_len, qc, p, cin,
              left_new, bval, bcol);
    left_old = s.prev[n];
    left_new = max(s.run[n - 1], cin) + p.indel * (j0 + n - 1);
    __syncthreads();
  }
  last = left_new;
  block_best(s, bval, bcol);
  if (threadIdx.x == 0 && bval > best && i <= k.q_len[b]) {
    best = bval;
    bi = i;
    bj = k.off + 1 + bcol;
  }
}

__global__ void __launch_bounds__(kThreads)
seqpar_step_kernel(Block k, int B, int row1, int R, int* prev,
                   const int* halo_diag0, const int* slab_in, int* slab_out,
                   uint8_t* codes, int* best_out, int* bi_out, int* bj_out,
                   Penalties p) {
  __shared__ Tile s;
  const int b = blockIdx.x;
  int* prev_row = prev + static_cast<long long>(b) * k.gb;
  int best = 0, bi = 0, bj = 0;
  if (threadIdx.x == 0) {
    best = best_out[b];
    bi = bi_out[b];
    bj = bj_out[b];
  }
  for (int r = 0; r < R; ++r) {
    const int i = row1 + r;
    const int halo_diag = r == 0 ? halo_diag0[b] : slab_in[(r - 1) * B + b];
    const int halo_left = slab_in[r * B + b];
    const int cin = slab_in[(R + r) * B + b];
    uint8_t* code_row =
        codes + (static_cast<long long>(i - 1) * B + b) * k.gb;
    int last, carry;
    full_row(s, k, b, i, prev_row, code_row, p, halo_diag, halo_left, cin,
             last, carry, best, bi, bj);
    if (threadIdx.x == 0) {
      slab_out[r * B + b] = last;
      slab_out[(R + r) * B + b] = max(cin, carry);
    }
    // the next row reads this row's dp from global memory
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    best_out[b] = best;
    bi_out[b] = bi;
    bj_out[b] = bj;
  }
}

__global__ void __launch_bounds__(kThreads)
seqpar_row_pre_kernel(Block k, int i, const int* prev, const int* halo_diag,
                      int* run, int* total, Penalties p) {
  __shared__ Tile s;
  const int b = blockIdx.x;
  const long long row_off = static_cast<long long>(b) * k.gb;
  const int qc = k.queries[b * k.q_stride + (i - 1)];
  int left_old = halo_diag[b];
  int carry = INT_MIN;
  for (int c0 = 0; c0 < k.gb; c0 += kTile) {
    const int n = min(kTile, k.gb - c0);
    load_tile(s, prev + row_off, k.genome, c0, n, left_old);
    carry = scan_tile(s, n, k.off + 1 + c0, k.g_len, qc, p, carry);
    for (int t = threadIdx.x; t < n; t += kThreads)
      run[row_off + c0 + t] = s.run[t];
    left_old = s.prev[n];
    __syncthreads();
  }
  if (threadIdx.x == 0) total[b] = carry;
}

__global__ void __launch_bounds__(kThreads)
seqpar_row_post_kernel(Block k, int B, int i, int* prev, const int* halo_diag,
                       const int* run, const int* totals, int index,
                       uint8_t* code_rows, int* last_out, int* best_out,
                       int* bi_out, int* bj_out, Penalties p) {
  __shared__ Tile s;
  const int b = blockIdx.x;
  const long long row_off = static_cast<long long>(b) * k.gb;
  const int qc = k.queries[b * k.q_stride + (i - 1)];
  int cin = kNeg;
  for (int d = 0; d < index; ++d) cin = max(cin, totals[d * B + b]);
  int left_old = halo_diag[b];
  int left_new = index == 0 ? 0 : cin + p.indel * k.off;
  int bval = -1, bcol = INT_MAX;
  for (int c0 = 0; c0 < k.gb; c0 += kTile) {
    const int n = min(kTile, k.gb - c0);
    const int j0 = k.off + 1 + c0;
    for (int t = threadIdx.x; t < n; t += kThreads)
      s.run[t] = run[row_off + c0 + t];
    load_tile(s, prev + row_off, k.genome, c0, n, left_old);
    emit_tile(s, prev + row_off, code_rows + row_off, c0, n, j0, k.g_len,
              qc, p, cin, left_new, bval, bcol);
    left_old = s.prev[n];
    left_new = max(s.run[n - 1], cin) + p.indel * (j0 + n - 1);
    __syncthreads();
  }
  block_best(s, bval, bcol);
  if (threadIdx.x == 0) {
    last_out[b] = left_new;
    if (bval > best_out[b] && i <= k.q_len[b]) {
      best_out[b] = bval;
      bi_out[b] = i;
      bj_out[b] = k.off + 1 + bcol;
    }
  }
}

Block make_block(const void* queries, long long q_stride, const void* q_len,
                 const void* genome, int gb, int off, int g_len) {
  return Block{static_cast<const int8_t*>(queries), q_stride,
               static_cast<const int*>(q_len),
               static_cast<const int8_t*>(genome), gb, off, g_len};
}

int finish(cudaError_t err) {
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches one kernel of B blocks on `stream` (a cudaStream_t)
// of `device`, not synchronised, and returns a cudaError_t as an int (0 =
// launched). The caller (ops/seqpar.py) checks shapes, types, contiguity,
// the rows' range and the exact range of the scores. Rows are 1-based.

// The pipelined variant's step: rows row1 .. row1 + R - 1.
int seqpar_step_launch(const void* queries, long long q_stride,
                       const void* q_len, const void* genome, int gb, int off,
                       int g_len, int B, int row1, int R, void* prev,
                       const void* halo_diag0, const void* slab_in,
                       void* slab_out, void* codes, void* best, void* bi,
                       void* bj, int match, int mismatch, int indel,
                       void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || R <= 0) return 0;
  if (gb <= 0 || row1 < 1) return cudaErrorInvalidValue;
  seqpar_step_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_block(queries, q_stride, q_len, genome, gb, off, g_len), B, row1,
      R, static_cast<int*>(prev), static_cast<const int*>(halo_diag0),
      static_cast<const int*>(slab_in), static_cast<int*>(slab_out),
      static_cast<uint8_t*>(codes), static_cast<int*>(best),
      static_cast<int*>(bi), static_cast<int*>(bj),
      Penalties{match, mismatch, indel});
  return finish(cudaSuccess);
}

// The per-row variant's first half of row i: `run` (B, Gb) and the block
// totals `total` (B,). q_len is not read.
int seqpar_row_pre_launch(const void* queries, long long q_stride,
                          const void* q_len, const void* genome, int gb,
                          int off, int g_len, int B, int i, const void* prev,
                          const void* halo_diag, void* run, void* total,
                          int match, int mismatch, int indel, void* stream,
                          int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  if (gb <= 0 || i < 1) return cudaErrorInvalidValue;
  seqpar_row_pre_kernel<<<B, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      make_block(queries, q_stride, q_len, genome, gb, off, g_len), i,
      static_cast<const int*>(prev), static_cast<const int*>(halo_diag),
      static_cast<int*>(run), static_cast<int*>(total),
      Penalties{match, mismatch, indel});
  return finish(cudaSuccess);
}

// The per-row variant's second half of row i: the (D, B) totals folded
// left of `index`, the row into `prev`, its codes into `code_rows` (B, Gb),
// its last column into `last` (B,), the best fold.
int seqpar_row_post_launch(const void* queries, long long q_stride,
                           const void* q_len, const void* genome, int gb,
                           int off, int g_len, int B, int i, void* prev,
                           const void* halo_diag, const void* run,
                           const void* totals, int D, int index,
                           void* code_rows, void* last, void* best, void* bi,
                           void* bj, int match, int mismatch, int indel,
                           void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  if (gb <= 0 || i < 1 || index < 0 || index >= D)
    return cudaErrorInvalidValue;
  seqpar_row_post_kernel<<<B, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      make_block(queries, q_stride, q_len, genome, gb, off, g_len), B, i,
      static_cast<int*>(prev), static_cast<const int*>(halo_diag),
      static_cast<const int*>(run), static_cast<const int*>(totals), index,
      static_cast<uint8_t*>(code_rows), static_cast<int*>(last),
      static_cast<int*>(best), static_cast<int*>(bi), static_cast<int*>(bj),
      Penalties{match, mismatch, indel});
  return finish(cudaSuccess);
}

}  // extern "C"
