// Pair-list no-gap overlap scores for Hopper (sm_90a), written by hand.
//
// Replaces the JAX package's pair scorer of the sparse route,
// genome_assembly_tpu/ops/overlap.py::overlap_scores (an XLA program: a
// batched one-hot matmul and a gather of its diagonals, run per chunk of
// 16,384 pairs by graph/build.py::_score_pairs_impl).
//
// What it computes, for each listed pair p = (a, b) = (ia[p], ib[p]):
//   for j = 1 .. len(b), with d = min(len(a), j), over the d aligned cells
//   a[len(a) - d + u] against b[j - d + u]:
//     cell = match     when both are bases (codes 0..3) and equal,
//            mismatch  when both are bases and differ,
//            0         when either is PAD or N (any other code);
//     score(j) = sum of the cells;
//   best = first strict maximum over j, starting from score 0 at j = 0.
// The PAD rule is that of overlap_scores' validity channel. The host C++
// scorer (gc_overlap_nogap_pairs) and the all-pairs kernel differ on reads
// with an N inside (ROADMAP §C 3); reads without one score the same.
//
// What bounds it on this card: the work is
// sum_pairs sum_{j <= len b} min(len a, j) cell comparisons, about 6.5e10
// for the 5.8 million candidate pairs of the long-genome path at k = 5,
// against 16 bytes a pair plus the read matrix once. Priced as 6 int8 ops a
// comparison at the int8 peak that is ~0.2 ms against ~0.03 ms for the
// bytes: the operations bound it.
//
// What the design does about that (a simple design; no tensor cores):
// - one warp per pair. The warp packs both reads into three bit planes in
//   shared memory (bit 0 of the code, bit 1, and "is a base inside the
//   length"), 32 positions a word, with three ballots per 32 positions,
//   and a zero word before and after each plane;
// - lane t takes the ends j = t + 1, t + 33, ...; for each it walks a's
//   words over the diagonal, shifts b's words into place with one funnel
//   shift a plane (the previous word kept in registers, so each step loads
//   three words of a and three of b), and counts 32 cells at a time:
//   both = va & vb, differ = (alo ^ blo) | (ahi ^ bhi),
//   matches += popc(both & ~differ), valid += popc(both);
//   score = mismatch * valid + (match - mismatch) * matches, exact in int32;
// - each lane keeps its first strict maximum over its increasing j; the
//   warp folds the lanes by score, then by the lower j.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // pairs a block
constexpr unsigned kFull = 0xffffffffu;

// Packs one read (its first `len` of `W` codes) into three planes of
// `nw + 2` words each: word 0 and word nw + 1 are zero, word 1 + w holds
// positions 32w .. 32w + 31 (bit t = position 32w + t).
__device__ __forceinline__ void pack_read(const int8_t* __restrict__ row,
                                          int len, int nw,
                                          uint32_t* planes, int lane) {
  const int stride = nw + 2;
  if (lane < 3) {
    planes[lane * stride] = 0u;
    planes[lane * stride + nw + 1] = 0u;
  }
  for (int w = 0; w < nw; ++w) {
    const int pos = 32 * w + lane;
    const int c = pos < len ? static_cast<int>(row[pos]) : 4;
    const bool base = static_cast<unsigned>(c) < 4u;
    const uint32_t lo = __ballot_sync(kFull, base && (c & 1));
    const uint32_t hi = __ballot_sync(kFull, base && (c & 2));
    const uint32_t valid = __ballot_sync(kFull, base);
    if (lane == 0) {
      planes[1 + w] = lo;
      planes[stride + 1 + w] = hi;
      planes[2 * stride + 1 + w] = valid;
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
overlap_pairs_kernel(const int8_t* __restrict__ codes,
                     const int32_t* __restrict__ lens, int W,
                     const int32_t* __restrict__ ia,
                     const int32_t* __restrict__ ib, long long n_pairs,
                     int match, int mismatch,
                     int32_t* __restrict__ score_out,
                     int32_t* __restrict__ end_out) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long p = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (p >= n_pairs) return;  // the whole warp; no block barrier follows
  const int nw = (W + 31) >> 5;
  const int stride = nw + 2;
  uint32_t* sa = smem + warp * 6 * stride;
  uint32_t* sb = sa + 3 * stride;
  const int ua = ia[p], ub = ib[p];
  const int la = lens[ua], lb = lens[ub];
  pack_read(codes + static_cast<long long>(ua) * W, la, nw, sa, lane);
  pack_read(codes + static_cast<long long>(ub) * W, lb, nw, sb, lane);
  __syncwarp();

  // word w of a plane at [1 + w]; b's word -1 (all zero) at [0]
  const uint32_t* a_lo = sa + 1;
  const uint32_t* a_hi = sa + stride + 1;
  const uint32_t* a_v = sa + 2 * stride + 1;
  const uint32_t* b_lo = sb + 1;
  const uint32_t* b_hi = sb + stride + 1;
  const uint32_t* b_v = sb + 2 * stride + 1;
  const int diff = match - mismatch;
  const int w_last = (la - 1) >> 5;  // -1 when a is empty
  int best_s = 0, best_j = 0;        // j = 0 scores 0
  for (int j = lane + 1; j <= lb; j += 32) {
    // a[u] faces b[u + o]; a's cells below -o face b's zero word -1
    const int o = j - la;
    const int w0 = o < 0 ? (-o) >> 5 : 0;
    const int base = 32 * w0 + o;    // >= -31
    int wi = base >> 5;              // floor: >= -1
    const int sh = base & 31;
    uint32_t lo0 = b_lo[wi], hi0 = b_hi[wi], v0 = b_v[wi];
    int matches = 0, valid = 0;
    for (int w = w0; w <= w_last; ++w) {
      // wi + 1 <= nw: the zero word after b's last
      const uint32_t lo1 = b_lo[wi + 1], hi1 = b_hi[wi + 1], v1 = b_v[wi + 1];
      const uint32_t blo = __funnelshift_r(lo0, lo1, sh);
      const uint32_t bhi = __funnelshift_r(hi0, hi1, sh);
      const uint32_t bv = __funnelshift_r(v0, v1, sh);
      const uint32_t both = a_v[w] & bv;
      const uint32_t differ = (a_lo[w] ^ blo) | (a_hi[w] ^ bhi);
      matches += __popc(both & ~differ);
      valid += __popc(both);
      lo0 = lo1;
      hi0 = hi1;
      v0 = v1;
      ++wi;
    }
    const int s = mismatch * valid + diff * matches;
    if (s > best_s) {
      best_s = s;
      best_j = j;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int os = __shfl_down_sync(kFull, best_s, off);
    const int oj = __shfl_down_sync(kFull, best_j, off);
    if (os > best_s || (os == best_s && oj < best_j)) {
      best_s = os;
      best_j = oj;
    }
  }
  if (lane == 0) {
    score_out[p] = best_s;
    end_out[p] = best_j;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of `device` without
// synchronising; returns a cudaError_t as an int (0 = launched).
// The caller checks shapes, types, contiguity, lengths in [0, W], pair
// indices in [0, U), W <= 4096 and the int32 range of the scores.
int overlap_pairs_launch(const void* codes, const void* lens, int W,
                         const void* ia, const void* ib, long long n_pairs,
                         int match, int mismatch, void* score_out,
                         void* end_out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_pairs <= 0) return 0;
  const long long blocks = (n_pairs + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL || W < 0) return cudaErrorInvalidValue;
  const int nw = (W + 31) / 32;
  // 24,960 bytes at W = 4096: under the 48 KB a block may take unasked
  const size_t smem = static_cast<size_t>(kWarps) * 6 * (nw + 2)
                      * sizeof(uint32_t);
  overlap_pairs_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const int32_t*>(lens),
      W, static_cast<const int32_t*>(ia), static_cast<const int32_t*>(ib),
      n_pairs, match, mismatch, static_cast<int32_t*>(score_out),
      static_cast<int32_t*>(end_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
