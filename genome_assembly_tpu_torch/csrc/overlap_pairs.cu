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
// sum_pairs sum_{j <= len b} min(len a, j) cell comparisons, 6.6e10 for the
// 5,772,298 candidate pairs of the long-genome path at k = 5, against 16
// bytes a pair plus the read matrix once. Priced as 6 int8 ops a comparison
// at the int8 tensor-core peak that is 0.1977 ms against 0.004 ms for the
// bytes: the operations bound it. This design runs on the integer pipes,
// and their floors are higher. At len a = len b = 150 (99.4% of those
// pairs) a warp runs 15 word-steps a pair (below), each three logic ops on
// the integer ALU pipe, one popcount and one add (IMAD, the FMA pipe),
// plus, a pair, 12 funnel shifts, ~35 ALU ops for the five ends' scores
// and ~40 around the pair: ~130 ALU warp-instructions a pair. The ALU pipe
// takes 16 lanes a clock a scheduler (64 an SM): 5.77e6 x 130 over 132 SMs
// x 2 warp-instructions a clock x 1.98 GHz is ~1.4 ms. Popcounts at 16 a
// clock an SM: 5.77e6 x 15 x 32 of them, ~0.66 ms. Dispatch at 4
// warp-instructions a clock an SM, ~200 a pair: ~1.1 ms. None reaches
// half the bound (0.4 ms); the tensor-core route is queued (ROADMAP §B).
//
// The design, and what each part does about what held the one-warp-a-pair
// design back (it packed both reads for every pair, ~152 times a read at
// k = 5, behind a dependent ia -> lengths -> codes chain of loads):
// - pack once a call. overlap_pairs_kernel_pack (a warp a read) writes three
//   bit planes of every read into the caller's scratch: bit 0 of the code,
//   bit 1, and "a base inside the length", 32 positions a word. Each plane
//   has a zero word before and after it and is padded to a multiple of four
//   words, so that a read's planes start on 16 bytes. Beside them a word
//   per read: its length, and a "clean" bit when every position below the
//   length holds a base 0..3;
// - a warp walks 32 consecutive pairs of the list in order
//   (overlap_pairs_kernel_pairs). It loads the 32 indices of each side and
//   their length words with one load each, keeps a's planes while ia
//   repeats (the join emits pairs sorted by (ia, ib): 76 pairs a source
//   read at k = 5) and reloads them only when ia changes. Any order stays
//   correct; sorting makes it faster;
// - b's planes arrive ahead of use: while pair p is scored, the warp stages
//   pair p + 1's b into the other half of a per-warp double buffer in
//   shared memory with cp.async, 16 bytes a lane (96 bytes at W = 150). No
//   byte loads, ballots or dependent loads are left in the pair loop;
// - warp-uniform word-steps. Lane t takes the ends j = len a - 32 k - t for
//   k from the lowest that reaches len b up to the last word of a. In step
//   k every lane's diagonal starts in the same word of a (max(k, 0)) and
//   faces, for a's word w, b's words w - k - 1 and w - k shifted by the
//   lane's own 32 - t (a clamped funnel shift). That shift does not depend
//   on k, so the lane shifts b's words once a pair and each word-step is
//   three logic ops, a popcount and an add, the same for every lane: 15
//   steps a pair at 150/150 where one lane a j in turn took 19 of ~19
//   instructions. For W <= 256 (at most 8 words a plane) the kernel is a
//   template on the word count: a's and b's planes sit in registers and
//   both loops unroll. Wider reads, up to MAX_W = 4096, take the generic
//   instance, with the planes in shared memory and a shift a step;
// - one popcount a word where both reads are clean: then the aligned cells
//   are all bases, valid(j) = min(len a, j), and only the matches are
//   counted, over a's length plane and, in a's first word, the lanes'
//   lower bound. Pairs with an N keep the validity plane and its popcount:
//   score = mismatch * valid + (match - mismatch) * matches, exact in int32;
// - each lane keeps its first strict maximum over its j: it meets them in
//   decreasing order and takes a score of at least the best so far (at
//   first at least 1, above j = 0's 0), so a tie goes to the lower j; the
//   warp folds the lanes by score, then by the lower j (two warp
//   reductions).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // warps a block, in both kernels
constexpr int kPairsAWarp = 32;    // consecutive pairs a warp walks
constexpr int kMaxRegWords = 8;    // W <= 256: planes in registers
constexpr int kPackWords = 8;      // words a warp loads at once to pack
constexpr int kMaxW = 4096;        // ops/overlap.py MAX_W
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLenMask = 0xffff;   // a length word: length | kCleanBit
constexpr int kCleanBit = 1 << 16;

// Words a plane takes in the scratch: a zero word, nw words, a zero word,
// padded to a multiple of four (ops/overlap.py plane_stride).
__host__ __device__ constexpr int plane_stride(int nw) {
  return (nw + 2 + 3) & ~3;
}

// A warp a read: the read's three planes (ps words each, plane q at
// [q * ps], word w at [q * ps + 1 + w]) and its length word.
__global__ void __launch_bounds__(kWarps * 32)
overlap_pairs_kernel_pack(const int8_t* __restrict__ codes,
                          const int32_t* __restrict__ lens, int n_reads,
                          int W, int nw, int ps,
                          uint32_t* __restrict__ planes,
                          int32_t* __restrict__ meta) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (r >= n_reads) return;
  const int len = lens[r];
  const int8_t* row = codes + r * W;
  uint32_t* out = planes + r * 3 * ps;
  bool dirty = false;
  // slots s0 .. s0 + 31 of each plane at a time, slot s0 + lane in lane's
  // registers (the zero words and the padding stay 0), three coalesced
  // stores a group; word w goes to slot 1 + w
  for (int s0 = 0; s0 < ps; s0 += 32) {
    uint32_t o0 = 0u, o1 = 0u, o2 = 0u;
    const int w_end = min(s0 + 31, nw);
    for (int w0 = max(s0 - 1, 0); w0 < w_end; w0 += kPackWords) {
      int c[kPackWords];                    // a batch's loads first
#pragma unroll
      for (int x = 0; x < kPackWords; ++x) {
        const int pos = 32 * (w0 + x) + lane;
        c[x] = w0 + x < w_end && pos < W ? static_cast<int>(row[pos]) : 4;
      }
#pragma unroll
      for (int x = 0; x < kPackWords; ++x) {
        if (w0 + x < w_end) {               // uniform across the warp
          const bool inside = 32 * (w0 + x) + lane < len;
          const bool base = inside && static_cast<unsigned>(c[x]) < 4u;
          dirty |= inside && !base;
          const uint32_t lo = __ballot_sync(kFull, base && (c[x] & 1));
          const uint32_t hi = __ballot_sync(kFull, base && (c[x] & 2));
          const uint32_t valid = __ballot_sync(kFull, base);
          if (lane == 1 + w0 + x - s0) {
            o0 = lo;
            o1 = hi;
            o2 = valid;
          }
        }
      }
    }
    if (s0 + lane < ps) {
      out[s0 + lane] = o0;
      out[ps + s0 + lane] = o1;
      out[2 * ps + s0 + lane] = o2;
    }
  }
  const bool clean = !__any_sync(kFull, dirty);
  if (lane == 0) meta[r] = len | (clean ? kCleanBit : 0);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 32 cells: a's word against b's word shifted into place. kClean: both
// reads are all bases inside their lengths, so `mask` (a's length plane,
// cut below the lane's first cell in a's first word) marks the aligned
// cells and `valid` is not counted; otherwise b's validity plane `bv`
// joins the mask and both are counted.
template <bool kClean>
__device__ __forceinline__ void count_cells(uint32_t alo, uint32_t ahi,
                                            uint32_t mask, uint32_t blo,
                                            uint32_t bhi, uint32_t bv,
                                            int& matches, int& valid) {
  const uint32_t differ = (alo ^ blo) | (ahi ^ bhi);
  if (kClean) {
    matches += __popc(mask & ~differ);
  } else {
    const uint32_t both = mask & bv;
    matches += __popc(both & ~differ);
    valid += __popc(both);
  }
}

// A lane's first strict maximum over its ends j = jm1 + 1 in 1 .. lb, met
// in decreasing order: it takes a score of at least `thr`, which starts at
// 1 (j = 0 scores 0 and is the lowest end) and then holds the best score,
// so a tie takes the lower j. The lane's best score is thr once best_j > 0.
__device__ __forceinline__ void take(int matches, int valid, int jm1, int lb,
                                     int match, int mismatch, int& thr,
                                     int& best_j) {
  const int s = mismatch * valid + (match - mismatch) * matches;
  if (static_cast<unsigned>(jm1) < static_cast<unsigned>(lb) && s >= thr) {
    thr = s;
    best_j = jm1 + 1;
  }
}

// Planes in registers: x[q][w] is word w of plane q (NW = the words a
// plane). The lane shifts b into its place once a pair: bs[q][i] is the
// funnel of b's words i - 1 and i (both zero outside 0 .. NW - 1), which
// every step k meets as the word facing a's word w = k + i. Words of a past
// its length are zero, so the word loop runs to NW - 1 without a guard.
template <int NW, bool kClean>
__device__ __forceinline__ void score_regs(
    const uint32_t (&a)[3][NW], const uint32_t (&b)[3][NW], int la, int lb,
    int lane, int match, int mismatch, int& thr, int& best_j) {
  const int w_last = (la - 1) >> 5;         // -1 when a is empty
  const int k_lo = -((lb - la + 31) >> 5);  // the lowest k with j <= lb
  const unsigned sh = 32 - lane;
  const uint32_t low = ~0u << lane;         // a's cells from -o = 32k + t
  uint32_t bs[3][NW + 1];
#pragma unroll
  for (int q = 0; q < (kClean ? 2 : 3); ++q) {
#pragma unroll
    for (int i = 0; i <= NW; ++i) {
      bs[q][i] = __funnelshift_rc(i > 0 ? b[q][i > 0 ? i - 1 : 0] : 0u,
                                  i < NW ? b[q][i < NW ? i : 0] : 0u, sh);
    }
  }
#pragma unroll
  for (int k = -NW; k < NW; ++k) {
    if (k >= k_lo && k <= w_last) {
      int matches = 0, valid = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const int i = w - k;                // compile-time; > NW: zero
        if (w >= k && i <= NW) {
          const int x = i <= NW ? i : 0;    // in bounds in dead bodies too
          count_cells<kClean>(a[0][w], a[1][w],
                              w == k ? (a[2][w] & low) : a[2][w], bs[0][x],
                              bs[1][x], kClean ? 0u : bs[2][x], matches,
                              valid);
        }
      }
      const int jm1 = la - 1 - lane - 32 * k;
      take(matches, kClean ? min(la, jm1 + 1) : valid, jm1, lb, match,
           mismatch, thr, best_j);
    }
  }
}

// Planes in shared memory (the generic instance): plane q of a read at
// [q * ps], word w at [q * ps + 1 + w]; words -1 and nw are zero.
template <bool kClean>
__device__ __forceinline__ void score_smem(
    const uint32_t* a, const uint32_t* b, int ps, int la, int lb, int lane,
    int match, int mismatch, int& thr, int& best_j) {
  const int w_last = (la - 1) >> 5;
  const int k_lo = -((lb - la + 31) >> 5);
  const unsigned sh = 32 - lane;
  const uint32_t low = ~0u << lane;
  for (int k = k_lo; k <= w_last; ++k) {
    int matches = 0, valid = 0;
    for (int w = k > 0 ? k : 0; w <= w_last; ++w) {
      const int i = w - k;                  // b's word w - k - 1 at [i]
      const uint32_t av = a[2 * ps + 1 + w];
      count_cells<kClean>(
          a[1 + w], a[ps + 1 + w], w == k ? (av & low) : av,
          __funnelshift_rc(b[i], b[i + 1], sh),
          __funnelshift_rc(b[ps + i], b[ps + i + 1], sh),
          kClean ? 0u : __funnelshift_rc(b[2 * ps + i], b[2 * ps + i + 1], sh),
          matches, valid);
    }
    const int jm1 = la - 1 - lane - 32 * k;
    take(matches, kClean ? min(la, jm1 + 1) : valid, jm1, lb, match,
         mismatch, thr, best_j);
  }
}

// A read's planes (PS words each) from 16-byte pieces into registers.
template <int NW, int PS>
__device__ __forceinline__ void planes_to_regs(const uint4* __restrict__ src,
                                               uint32_t (&x)[3][NW]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    uint32_t words[PS];
#pragma unroll
    for (int c = 0; c < PS / 4; ++c) {
      const uint4 v = src[q * (PS / 4) + c];
      words[4 * c] = v.x;
      words[4 * c + 1] = v.y;
      words[4 * c + 2] = v.z;
      words[4 * c + 3] = v.w;
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) x[q][w] = words[1 + w];
  }
}

// NW in 1..kMaxRegWords: planes of NW words in registers; NW = 0: the
// generic instance, planes in shared memory. A warp scores pairs
// p0 .. p0 + 31 in order; shared memory holds, a warp, b's double buffer
// and (NW = 0) a's planes.
template <int NW>
__global__ void __launch_bounds__(kWarps * 32)
overlap_pairs_kernel_pairs(const uint32_t* __restrict__ planes,
                           const int32_t* __restrict__ meta, int ps,
                           const int32_t* __restrict__ ia,
                           const int32_t* __restrict__ ib, long long n_pairs,
                           int match, int mismatch,
                           int32_t* __restrict__ score_out,
                           int32_t* __restrict__ end_out) {
  extern __shared__ uint4 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long p0 =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * kPairsAWarp;
  if (p0 >= n_pairs) return;  // the whole warp; no block barrier follows
  const int n = static_cast<int>(
      n_pairs - p0 < kPairsAWarp ? n_pairs - p0 : kPairsAWarp);
  // 16-byte pieces a read (a constant in the register instances)
  const int r16 = NW ? 3 * plane_stride(NW) / 4 : 3 * ps / 4;
  uint4* bbuf = smem + warp * (NW ? 2 : 3) * r16;
  const uint4* src = reinterpret_cast<const uint4*>(planes);

  // the chunk's pairs and length words, lane i holding pair p0 + i
  int my_a = 0, my_b = 0;
  if (lane < n) {
    my_a = ia[p0 + lane];
    my_b = ib[p0 + lane];
  }
  const int my_ma = lane < n ? meta[my_a] : 0;
  const int my_mb = lane < n ? meta[my_b] : 0;

  auto stage = [&](int i) {                 // b of pair p0 + i
    const int ub = __shfl_sync(kFull, my_b, i);
    uint4* dst = bbuf + (i & 1) * r16;
    const uint4* from = src + static_cast<long long>(ub) * r16;
    for (int c = lane; c < r16; c += 32) cp_async16(dst + c, from + c);
    cp_async_commit();
  };

  stage(0);
  int cur_a = -1, ma = 0;
  uint32_t a[3][NW ? NW : 1];
  uint32_t b[3][NW ? NW : 1];
  uint4* abuf = bbuf + 2 * r16;             // NW = 0 only
  int out_s = 0, out_j = 0;
  for (int i = 0; i < n; ++i) {
    const int ua = __shfl_sync(kFull, my_a, i);
    const int ma_i = __shfl_sync(kFull, my_ma, i);
    const int mb = __shfl_sync(kFull, my_mb, i);
    if (ua != cur_a) {                      // uniform across the warp
      cur_a = ua;
      ma = ma_i;
      const uint4* from = src + static_cast<long long>(ua) * r16;
      if constexpr (NW > 0) {
        planes_to_regs<NW, plane_stride(NW)>(from, a);
      } else {
        __syncwarp();                       // a's old planes are read
        for (int c = lane; c < r16; c += 32) cp_async16(abuf + c, from + c);
        cp_async_commit();
      }
    }
    cp_async_wait_all();
    __syncwarp();  // b (and a) of this pair are in; pair i - 1's reads done
    const uint4* bcur = bbuf + (i & 1) * r16;
    if constexpr (NW > 0) planes_to_regs<NW, plane_stride(NW)>(bcur, b);
    if (i + 1 < n) stage(i + 1);            // the other half, read at i - 1
    const int la = ma & kLenMask, lb = mb & kLenMask;
    const bool clean = (ma & mb & kCleanBit) != 0;   // uniform
    int thr = 1, best_j = 0;                // j = 0 scores 0
    if constexpr (NW > 0) {
      if (clean) {
        score_regs<NW, true>(a, b, la, lb, lane, match, mismatch, thr,
                             best_j);
      } else {
        score_regs<NW, false>(a, b, la, lb, lane, match, mismatch, thr,
                              best_j);
      }
    } else {
      const uint32_t* as = reinterpret_cast<const uint32_t*>(abuf);
      const uint32_t* bs = reinterpret_cast<const uint32_t*>(bcur);
      if (clean) {
        score_smem<true>(as, bs, ps, la, lb, lane, match, mismatch, thr,
                         best_j);
      } else {
        score_smem<false>(as, bs, ps, la, lb, lane, match, mismatch, thr,
                          best_j);
      }
    }
    const int best_s = best_j > 0 ? thr : 0;
    const int s = __reduce_max_sync(kFull, best_s);
    const unsigned j = __reduce_min_sync(
        kFull, best_s == s ? static_cast<unsigned>(best_j) : 0xffffffffu);
    if (lane == i) {
      out_s = s;
      out_j = static_cast<int>(j);
    }
  }
  if (lane < n) {
    score_out[p0 + lane] = out_s;
    end_out[p0 + lane] = out_j;
  }
}

template <int NW>
cudaError_t launch_pairs(const uint32_t* planes, const int32_t* meta, int ps,
                         const int32_t* ia, const int32_t* ib,
                         long long n_pairs, int match, int mismatch,
                         int32_t* score_out, int32_t* end_out,
                         cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kWarps) * kPairsAWarp;
  const long long blocks = (n_pairs + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // 38,016 bytes at W = 4096 (NW = 0): under the 48 KB a block may take
  // unasked
  const size_t smem = static_cast<size_t>(kWarps) * (NW ? 2 : 3) * 3 * ps
                      * sizeof(uint32_t);
  overlap_pairs_kernel_pairs<NW><<<static_cast<unsigned>(blocks),
                                   kWarps * 32, smem, stream>>>(
      planes, meta, ps, ia, ib, n_pairs, match, mismatch, score_out,
      end_out);
  return cudaGetLastError();
}

// Words of scratch a launch needs for n_reads reads of padded width W:
// three planes of plane_stride(ceil(W / 32)) words and a length word a
// read (ops/overlap.py scratch_words).
long long scratch_words(int n_reads, int W) {
  return static_cast<long long>(n_reads)
         * (3 * plane_stride((W + 31) / 32) + 1);
}

}  // namespace

extern "C" {

// Packs the reads into `scratch` (int32, 16-byte aligned, at least
// scratch_words(n_reads, W) words) and scores the pairs: two kernels on
// `stream` (a cudaStream_t) of `device`, not synchronised. Returns a
// cudaError_t as an int (0 = launched). The caller checks shapes, types,
// contiguity, lengths in [0, W], pair indices in [0, n_reads), W <= 4096
// and the int32 range of the scores.
int overlap_pairs_launch(const void* codes, const void* lens, int n_reads,
                         int W, const void* ia, const void* ib,
                         long long n_pairs, int match, int mismatch,
                         void* score_out, void* end_out, void* scratch,
                         long long n_scratch, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_pairs <= 0) return 0;
  if (n_reads <= 0 || W < 0 || W > kMaxW
      || n_scratch < scratch_words(n_reads, W)
      || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return cudaErrorInvalidValue;
  const int nw = (W + 31) / 32;
  const int ps = plane_stride(nw);
  uint32_t* planes = static_cast<uint32_t*>(scratch);
  int32_t* meta = reinterpret_cast<int32_t*>(
      planes + static_cast<long long>(n_reads) * 3 * ps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pack_blocks = (n_reads + kWarps - 1) / kWarps;
  overlap_pairs_kernel_pack<<<pack_blocks, kWarps * 32, 0, s>>>(
      static_cast<const int8_t*>(codes), static_cast<const int32_t*>(lens),
      n_reads, W, nw, ps, planes, meta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int32_t* pa = static_cast<const int32_t*>(ia);
  const int32_t* pb = static_cast<const int32_t*>(ib);
  int32_t* so = static_cast<int32_t*>(score_out);
  int32_t* eo = static_cast<int32_t*>(end_out);
  switch (nw) {
    case 0:  // no words: every length is 0; the one-word instance
    case 1: err = launch_pairs<1>(planes, meta, ps, pa, pb, n_pairs, match,
                                  mismatch, so, eo, s); break;
    case 2: err = launch_pairs<2>(planes, meta, ps, pa, pb, n_pairs, match,
                                  mismatch, so, eo, s); break;
    case 3: err = launch_pairs<3>(planes, meta, ps, pa, pb, n_pairs, match,
                                  mismatch, so, eo, s); break;
    case 4: err = launch_pairs<4>(planes, meta, ps, pa, pb, n_pairs, match,
                                  mismatch, so, eo, s); break;
    case 5: err = launch_pairs<5>(planes, meta, ps, pa, pb, n_pairs, match,
                                  mismatch, so, eo, s); break;
    case 6: err = launch_pairs<6>(planes, meta, ps, pa, pb, n_pairs, match,
                                  mismatch, so, eo, s); break;
    case 7: err = launch_pairs<7>(planes, meta, ps, pa, pb, n_pairs, match,
                                  mismatch, so, eo, s); break;
    case 8: err = launch_pairs<8>(planes, meta, ps, pa, pb, n_pairs, match,
                                  mismatch, so, eo, s); break;
    default: err = launch_pairs<0>(planes, meta, ps, pa, pb, n_pairs, match,
                                   mismatch, so, eo, s); break;
  }
  static_assert(kMaxRegWords == 8, "the switch above instances 1..8");
  return static_cast<int>(err);
}

}  // extern "C"
