// Batched Smith-Waterman local alignment with its traceback walk, for
// Hopper (sm_90a), written by hand: two kernels, full width and banded.
//
// Replaces the JAX package's device row scans (XLA programs, not Pallas
// kernels) in genome_assembly_tpu/ops/smith_waterman.py:
// - sw_full_kernel:   local_align_batch_ops (:155), i.e. local_align_batch
//                     (:37) fused with traceback_device (:110);
// - sw_banded_kernel: local_align_batch_banded (:174).
//
// What they compute, per item (query q of length n against genome g of
// length m), with the reference's semantics (aligners.py:85-167):
//   H(i, j) = max(H(i-1, j-1) + s(q[i-1], g[j-1]), H(i-1, j) + indel,
//                 H(i, j-1) + indel, 0)
// where bases compare with == on their codes (N matches N), a traceback
// code per cell from the cascade diag >= up >= left (code 0 wherever
// H == 0), the best cell as the first strict maximum in row-major order,
// and the walk from it back to a code 0 or the matrix edge, emitted as a
// backwards op stream (1 = diag, 2 = up, 3 = left, then zeros).
// - full width: the item's window is the suffix g[m - w:] (the whole
//   genome, or the tail window genome[-n:] of a short contig), columns
//   j = 1 .. w in window coordinates; the contract of the C++ engine's
//   gc_local_align_batch (native/graphcore.cpp), so one genome is read,
//   never B copies of it;
// - banded: only the 2 * band + 1 cells |j - i - d0| <= band of each row,
//   in band slots t = j - (d0 - band + i), with the gap moves that leave
//   the band masked, columns outside [1, m] zero, and best_j, start_j in
//   genome coordinates; the contract of gc_local_align_banded_batch.
//
// What bounds them on this card: the work is a few integer operations per
// DP cell (2.5e9 cells on the PhiX main path, 7.8e8 banded cells on the
// 50 kb path) against bytes that are tiny beside it (the reads and one
// genome in, the op streams out), so integer throughput bounds them. The
// fewest operations per cell this design needs are 3: the substitution
// select, the DPX max of the three moves with the 0 clamp
// (__vimax3_s32_relu) and the code select.
//
// What the design does about that:
// - one lane per query row; a strip of 32 rows sweeps its columns as an
//   anti-diagonal wavefront, lane k at column t - k + 1 at step t, so every
//   cell's three inputs are in registers: its own last value (left), lane
//   k-1's last value by one shuffle (up), and the up value of the step
//   before (diag). The DP values never touch memory;
// - steps run in unrolled blocks of 16, and each block's loads are issued
//   one block ahead: the 16 genome codes a lane will face (five aligned
//   words and four funnel shifts, from a copy of the genome the wrapper
//   pads by GENOME_PAD codes on each side) and lane 0's 16 values of the
//   row above (four 16-byte loads). A cell then costs about 25
//   instructions, one of them the shuffle, and no load waits;
// - one block of W warps (W = 1, 2, 4 or 8, one instantiation each, the
//   wrapper's choice per launch) aligns one item: warp v runs the item's
//   strips v, v + W, v + 2 W, ..., so a contig of S strips takes about
//   ceil(S / W) strip sweeps instead of S. Lane 31 of strip s stores the
//   strip's last row into a row buffer in device memory (two per item,
//   strip s writes buffer (s + 1) & 1 and reads buffer s & 1), and lane 0
//   of strip s + 1 reads it a block ahead of use;
// - the wait: after each block, lane 31 fences and publishes its warp's
//   progress, strip * steps + steps done, to shared memory (monotone across
//   the warp's strips). Before lane 0 of strip s + 1 issues the load of
//   the row-buffer indices tb + 1 .. tb + 16, it spins until strip s has
//   done the steps that store them: lane 31 stores index c at its step
//   c + kStoreLag (30 full width, 62 banded), so through step
//   tb + 16 + kStoreLag. At W = 1 the strips run in order on one warp and
//   there is no wait;
// - why two row buffers suffice: strip s + 2 overwrites the buffer that
//   strip s + 1 reads, but strip s + 2 waits on strip s + 1. When it
//   stores index c (at its step c + kStoreLag), strip s + 1 has done at
//   least c + 78 steps (c + 126 banded), and lane 0 used index c at step
//   c - 1, so no index is overwritten before it is read; every later strip
//   that writes the buffer waits on a chain through s + 1. The CPU
//   emulation (tests/test_torch_smith_waterman.py) runs the real two
//   buffers under the interleavings the wait allows;
// - traceback codes are 2 bits, packed 16 steps to a word per lane and
//   written as one coalesced 128-byte store per block (0.25 byte per
//   cell, scratch the wrapper sizes per launch);
// - each lane keeps the first strict maximum of its row; a strip reduces
//   them (highest score, then lowest row), each warp folds its strips in
//   order with strict >, and the block folds its warps by highest score,
//   then lowest row (the warps' strips interleave, so never by warp), so
//   the row-major first maximum comes out exact;
// - after a barrier lane 0 of warp 0 walks the codes (all warps' stores
//   are visible after it) and writes the op stream;
// - items are taken longest first (the wrapper orders them). The two
//   kernels are one template: only the mapping from step to column and the
//   edges of the valid cells differ.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
// Nanoseconds a waiting warp sleeps between polls of its neighbour's
// progress (a 16-step block takes about 1,600 ns under load)
constexpr unsigned kSpinSleepNs = 100;
constexpr int kBlock = 16;  // steps per unrolled block = codes per word
// The row buffers keep the value of column (or band slot) x at x + kPad, so
// that lane 0's 16 values of a block start on a 16-byte boundary.
constexpr int kPad = 15;
// Codes of padding on each side of the genome (ops/smith_waterman.py
// GENOME_PAD): a block reads 20 bytes around positions clamped to
// [-48, m + 16], so every load stays inside the padded copy.
constexpr int kGenomePad = 64;
static_assert(kGenomePad >= 48 + 3 && kGenomePad >= 16 + 20,
              "a block's genome loads must stay inside the padding");

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// The 16 genome codes at positions p .. p + 15 (relative to `ref`), as four
// words of four codes each. Blocks whose positions lie wholly outside
// [0, m) hold no valid cell; their start is clamped and their codes unused.
struct RefBlock {
  uint32_t w[4];
};

__device__ __forceinline__ RefBlock load_ref(const int8_t* ref, int p,
                                             int lo_p, int hi_p) {
  const uintptr_t at =
      reinterpret_cast<uintptr_t>(ref + clampi(p, lo_p, hi_p));
  const uint32_t* words = reinterpret_cast<const uint32_t*>(at & ~uintptr_t{3});
  const unsigned sh = 8u * static_cast<unsigned>(at & 3u);
  uint32_t raw[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) raw[k] = __ldg(words + k);
  RefBlock b;
#pragma unroll
  for (int k = 0; k < 4; ++k) b.w[k] = __funnelshift_r(raw[k], raw[k + 1], sh);
  return b;
}

// Lane 0's 16 values of the row above for a block (zeros for strip 0).
struct AboveBlock {
  int v[kBlock];
};

__device__ __forceinline__ AboveBlock load_above(const int32_t* hin, int tb,
                                                 bool first_strip) {
  AboveBlock a;
  if (first_strip) {
#pragma unroll
    for (int u = 0; u < kBlock; ++u) a.v[u] = 0;
  } else {
    const int4* src = reinterpret_cast<const int4*>(hin + tb + kPad + 1);
#pragma unroll
    for (int k = 0; k < kBlock / 4; ++k) {
      const int4 x = __ldcg(src + k);
      a.v[4 * k] = x.x;
      a.v[4 * k + 1] = x.y;
      a.v[4 * k + 2] = x.z;
      a.v[4 * k + 3] = x.w;
    }
  }
  return a;
}

// The cascade diag >= up >= left on the cell's value h = max(diag, up,
// left, 0): for h > 0, diag wins iff it equals h, then up iff it equals h.
__device__ __forceinline__ uint32_t tb_code(int h, int diag, int up) {
  const uint32_t c = h == diag ? 1u : (h == up ? 2u : 3u);
  return h > 0 ? c : 0u;
}

// Lane 31's lag behind lane 0, in steps: lanes start one (full width) or
// two (banded) steps after the lane before.
__host__ __device__ constexpr int last_lane_shift(bool banded) {
  return banded ? 62 : 31;
}

// Lane 31 stores its value at x (column - 1, or band slot) into the row
// buffer at index x + store_offset: by column (full width) or slot.
__host__ __device__ constexpr int store_offset(bool banded) {
  return banded ? 0 : 1;
}

// Steps after which lane 31 has stored row-buffer index c: at step c + lag.
__host__ __device__ constexpr int store_lag(bool banded) {
  return last_lane_shift(banded) - store_offset(banded);
}
static_assert(store_lag(false) == 30 && store_lag(true) == 62,
              "lane 31 stores index c at step c + 30 (full), c + 62 (banded)");

__device__ __forceinline__ int strip_steps(bool banded, int width) {
  return width + last_lane_shift(banded);
}

// Lane 0 of the calling warp spins until *progress reaches target, then
// the whole warp goes on (acquire: the fence orders the row-buffer loads
// that follow after the flag's read). It sleeps between polls, so that a
// waiting warp does not take issue slots from the integer pipe the other
// warps of its SM are bound by.
__device__ __forceinline__ void wait_progress(
    const volatile long long* progress, long long target) {
  if ((threadIdx.x & 31) == 0) {
    while (*progress < target) __nanosleep(kSpinSleepNs);
    __threadfence_block();
  }
  __syncwarp();
}

__device__ __forceinline__ uint32_t read_code(const uint32_t* codes, int n16,
                                              int i, int step) {
  const int s = (i - 1) >> 5;
  const int k = (i - 1) & 31;
  const uint32_t word =
      __ldcg(codes + (static_cast<long long>(s) * n16 + (step >> 4)) * 32 + k);
  return (word >> (2 * (step & 15))) & 3u;
}

// One block of kW warps aligns one item; warp v runs strips v, v + kW, ...
// Lane k of strip s owns query row i = 32 s + 1 + k and at step t computes
//   full width: column j = t - k + 1 of the window (1 <= j <= w);
//   banded:     band slot t - 2 k, column jlo(i) + slot with
//               jlo(i) = d0 - band + i (slots 0 .. 2 band, 1 <= j <= m).
// In both, lane k - 1 was at the same column one step earlier (up) and at
// the column before two steps earlier (diag, kept from the last step).
template <bool kBanded, int kW>
__global__ void __launch_bounds__(32 * kW)
sw_kernel(const int8_t* __restrict__ q, long long q_stride,
          const int32_t* __restrict__ q_len,
          const int8_t* __restrict__ genome, int m,
          const int32_t* __restrict__ per_item, int band,
          const int32_t* __restrict__ order,
          const long long* __restrict__ off,
          int32_t* __restrict__ scratch, int match, int mismatch, int indel,
          long long ops_stride, int32_t* __restrict__ out_best,
          int32_t* __restrict__ out_bi, int32_t* __restrict__ out_bj,
          int32_t* __restrict__ out_start, uint8_t* __restrict__ ops) {
  // each warp's progress: strip * steps + steps done (kW > 1 only)
  __shared__ long long progress[kW];
  __shared__ int fold_best[kW], fold_bi[kW], fold_at[kW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pos = blockIdx.x;
  const int item = order[pos];
  const int n = q_len[item];
  // full width: the window is the suffix g[m - w:]; banded: the genome
  const int w = kBanded ? m : per_item[item];
  const int d0 = kBanded ? per_item[item] : 0;
  const int width = kBanded ? 2 * band + 1 : w;  // columns or slots a row
  const int8_t* ref = genome + (m - w);
  const int steps = strip_steps(kBanded, width);
  const int n16 = (steps + kBlock - 1) / kBlock;
  const int strips = (n + 31) >> 5;
  const long long code_words = static_cast<long long>(strips) * n16 * 32;
  const int hstride = (steps + 48 + 31) & ~31;
  uint32_t* codes = reinterpret_cast<uint32_t*>(scratch + off[pos]);
  int32_t* hbuf0 = scratch + off[pos] + code_words;
  int32_t* hbuf1 = hbuf0 + hstride;
  volatile long long* prog = progress;
  // the warp whose strips come right before this warp's
  const volatile long long* prev = progress + (warp + kW - 1) % kW;
  if (kW > 1) {
    if (threadIdx.x < kW) progress[threadIdx.x] = 0;
    __syncthreads();
  }
  int best = 0, bi = 0, bat = 0;  // bat: best column (full) or slot

  if (n > 0 && w > 0) {
    const int8_t* qp = q + static_cast<long long>(item) * q_stride;
    for (int s = warp; s < strips; s += kW) {
      const int32_t* hin = (s & 1) ? hbuf1 : hbuf0;  // row 32 s
      int32_t* hout = (s & 1) ? hbuf0 : hbuf1;       // row 32 s + 32
      // strip s - 1 has stored the row-buffer indices up to tb + 16 once
      // it has done `done_for(tb)` steps
      const long long before = static_cast<long long>(s - 1) * steps;
      auto done_for = [&](int tb) {
        return before + min(steps, tb + kBlock + store_lag(kBanded) + 1);
      };
      if (kW > 1 && s > 0) wait_progress(prev, done_for(0));
      const int i = 32 * s + 1 + lane;
      const bool row_ok = i <= n;
      // codes compare as bytes (-1: rows past the query match nothing)
      const int qc = row_ok ? static_cast<uint8_t>(qp[i - 1]) : -1;
      // at step t this lane is at x = t - shift (column - 1, or slot) and
      // faces ref[x + ref0]; its cells count for x in [lo, lo + count)
      const int shift = kBanded ? 2 * lane : lane;
      const int ref0 = kBanded ? d0 - band + i - 1 : 0;
      int lo = 0, hi = width - 1;
      if (kBanded) {
        lo = max(0, -ref0);
        hi = min(hi, m - 1 - ref0);
      }
      const unsigned count = row_ok && hi >= lo ? hi - lo + 1 : 0u;
      uint32_t* crow = codes + static_cast<long long>(s) * n16 * 32 + lane;
      int h = 0;  // this lane's value of the last step (left)
      // diag of lane 0 at its first cell: column 0 reads 0; slot 0 of the
      // row above
      int hd = (kBanded && lane == 0 && s > 0) ? __ldcg(hin + kPad) : 0;
      int lane_best = 0, lane_at = 0;
      // positions relative to `ref` whose block may hold a valid cell
      const int lo_p = -48, hi_p = w + 16;
      AboveBlock next_above = load_above(hin, 0, s == 0);
      RefBlock next_ref = load_ref(ref, ref0 - shift, lo_p, hi_p);
      for (int tb = 0; tb < steps; tb += kBlock) {
        const AboveBlock above = next_above;  // lane 0's up, index tb + 1 + u
        const RefBlock rb = next_ref;
        const int xb = tb - shift;  // this lane's x at step tb
        if (tb + kBlock < steps) {  // the next block's loads, in flight now
          if (kW > 1 && s > 0) wait_progress(prev, done_for(tb + kBlock));
          next_above = load_above(hin, tb + kBlock, s == 0);
          next_ref = load_ref(ref, xb + kBlock + ref0, lo_p, hi_p);
        }
        uint32_t cw = 0;
#pragma unroll
        for (int u = 0; u < kBlock; ++u) {
          int from_above = __shfl_up_sync(kFullMask, h, 1);
          if (lane == 0)  // a banded row's slot past the band reads 0
            from_above = (!kBanded || tb + u + 1 < width) ? above.v[u] : 0;
          const int x = xb + u;
          const bool ok = static_cast<unsigned>(x - lo) < count;
          const int rc = (rb.w[u / 4] >> (8 * (u % 4))) & 0xff;
          const int diag = hd + (rc == qc ? match : mismatch);
          const int up = from_above + indel;
          const int hn = __vimax3_s32_relu(diag, up, h + indel);
          cw |= tb_code(hn, diag, up) << (2 * u);
          if (ok && hn > lane_best) {
            lane_best = hn;
            lane_at = x;
          }
          hd = from_above;
          h = ok ? hn : 0;  // outside the window, band or genome: 0
          // lane 31 hands its row to the next strip, by index x + 1
          // (full) or slot x (banded); past the row's end it stores 0
          if (lane == 31 && x >= -store_offset(kBanded))
            hout[x + store_offset(kBanded) + kPad] = h;
        }
        crow[(tb / kBlock) * 32] = cw;
        if (kW > 1 && lane == 31) {  // publish: this block's stores are done
          __threadfence_block();
          prog[warp] = static_cast<long long>(s) * steps +
                       min(steps, tb + kBlock);
        }
      }
      const int smax = __reduce_max_sync(kFullMask, lane_best);
      if (smax > best) {  // the first strict maximum in row-major order
        const unsigned who = __ballot_sync(kFullMask, lane_best == smax);
        const int src = __ffs(who) - 1;
        best = smax;
        bi = 32 * s + 1 + src;
        bat = __shfl_sync(kFullMask, lane_at, src);
      }
      __syncwarp();  // row buffers and codes visible to the whole warp
    }
  }

  if (kW > 1) {
    // the block's first maximum: highest score, then lowest row (every
    // warp's strips interleave with the others', so not by warp)
    if (lane == 0) {
      fold_best[warp] = best;
      fold_bi[warp] = bi;
      fold_at[warp] = bat;
    }
    __syncthreads();  // also makes every warp's codes visible to the walk
    if (threadIdx.x == 0) {
      for (int v = 1; v < kW; ++v) {
        if (fold_best[v] > best || (fold_best[v] == best && fold_bi[v] < bi)) {
          best = fold_best[v];
          bi = fold_bi[v];
          bat = fold_at[v];
        }
      }
    }
  }

  if (threadIdx.x != 0) return;
  uint8_t* op = ops + static_cast<long long>(item) * ops_stride;
  long long n_ops = 0;
  if (!kBanded) {
    // from (bi, bj = bat + 1): diag (i-1, j-1), up (i-1, j), left (i, j-1)
    int i = bi, j = bat + 1;
    if (best == 0) j = 0;
    while (i > 0 && j > 0 && n_ops < ops_stride) {
      const uint32_t c = read_code(codes, n16, i, j - 1 + ((i - 1) & 31));
      if (c == 0) break;
      op[n_ops++] = static_cast<uint8_t>(c);
      if (c != 3) --i;
      if (c != 2) --j;
    }
    out_best[item] = best;
    out_bi[item] = bi;
    out_bj[item] = best > 0 ? bat + 1 : 0;
    out_start[item] = j;
  } else if (best > 0) {
    // band slots: diag (i-1, t), up (i-1, t+1), left (i, t-1)
    int i = bi, t = bat;
    while (i > 0 && d0 - band + i + t > 0 && t >= 0 && t < width &&
           n_ops < ops_stride) {
      const uint32_t c = read_code(codes, n16, i, t + 2 * ((i - 1) & 31));
      if (c == 0) break;
      op[n_ops++] = static_cast<uint8_t>(c);
      if (c != 3) --i;
      if (c == 2) ++t;
      if (c == 3) --t;
    }
    out_best[item] = best;
    out_bi[item] = bi;
    out_bj[item] = d0 - band + bi + bat;
    out_start[item] = d0 - band + i + t;
  } else {
    out_best[item] = out_bi[item] = out_bj[item] = out_start[item] = 0;
  }
}

template <bool kBanded, int kW>
cudaError_t launch_with(unsigned blocks, cudaStream_t stream, const void* q,
                        long long q_stride, const void* q_len,
                        const void* genome, int m, const void* per_item,
                        int band, const void* order, const void* off,
                        void* scratch, int match, int mismatch, int indel,
                        long long ops_stride, void* out_best, void* out_bi,
                        void* out_bj, void* out_start, void* ops) {
  sw_kernel<kBanded, kW><<<blocks, 32 * kW, 0, stream>>>(
      static_cast<const int8_t*>(q), q_stride,
      static_cast<const int32_t*>(q_len), static_cast<const int8_t*>(genome),
      m, static_cast<const int32_t*>(per_item), band,
      static_cast<const int32_t*>(order), static_cast<const long long*>(off),
      static_cast<int32_t*>(scratch), match, mismatch, indel, ops_stride,
      static_cast<int32_t*>(out_best), static_cast<int32_t*>(out_bi),
      static_cast<int32_t*>(out_bj), static_cast<int32_t*>(out_start),
      static_cast<uint8_t*>(ops));
  return cudaGetLastError();
}

template <bool kBanded>
int launch(const void* q, long long q_stride, const void* q_len,
           const void* genome, int m, const void* per_item, int band,
           const void* order, const void* off, int n_items, void* scratch,
           int match, int mismatch, int indel, long long ops_stride,
           void* out_best, void* out_bi, void* out_bj, void* out_start,
           void* ops, void* stream, int device, int warps) {
  if (warps != 1 && warps != 2 && warps != 4 && warps != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_items <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>(n_items);  // one per item
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SW_LAUNCH(W)                                                        \
  launch_with<kBanded, W>(blocks, st, q, q_stride, q_len, genome, m,        \
                          per_item, band, order, off, scratch, match,       \
                          mismatch, indel, ops_stride, out_best, out_bi,    \
                          out_bj, out_start, ops)
  switch (warps) {
    case 1: err = SW_LAUNCH(1); break;
    case 2: err = SW_LAUNCH(2); break;
    case 4: err = SW_LAUNCH(4); break;
    default: err = SW_LAUNCH(8); break;
  }
#undef SW_LAUNCH
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Each launches one kernel on `stream` (a cudaStream_t) of `device` without
// synchronising, with `warps` (1, 2, 4 or 8; any other value returns
// cudaErrorInvalidValue) warps to an item, and returns a cudaError_t as an
// int (0 = launched). The
// items are order[0 .. n_items); item order[p] owns the int32 scratch at
// scratch + off[p] (codes, then two row buffers; sizes in
// ops/smith_waterman.py). `genome` points at the first of m codes with
// kGenomePad PAD codes before and after them. The caller checks shapes,
// types, the lengths' ranges, indel <= 0, the int32 range of the scores
// and zero-fills `ops`.
int sw_full_launch(const void* q, long long q_stride, const void* q_len,
                   const void* genome, int m, const void* w_len,
                   const void* order, const void* off, int n_items,
                   void* scratch, int match, int mismatch, int indel,
                   long long ops_stride, void* out_best, void* out_bi,
                   void* out_bj, void* out_start, void* ops, void* stream,
                   int device, int warps) {
  return launch<false>(q, q_stride, q_len, genome, m, w_len, 0, order, off,
                       n_items, scratch, match, mismatch, indel, ops_stride,
                       out_best, out_bi, out_bj, out_start, ops, stream,
                       device, warps);
}

int sw_banded_launch(const void* q, long long q_stride, const void* q_len,
                     const void* genome, int m, const void* d0, int band,
                     const void* order, const void* off, int n_items,
                     void* scratch, int match, int mismatch, int indel,
                     long long ops_stride, void* out_best, void* out_bi,
                     void* out_bj, void* out_start, void* ops, void* stream,
                     int device, int warps) {
  return launch<true>(q, q_stride, q_len, genome, m, d0, band, order, off,
                      n_items, scratch, match, mismatch, indel, ops_stride,
                      out_best, out_bi, out_bj, out_start, ops, stream,
                      device, warps);
}

}  // extern "C"
