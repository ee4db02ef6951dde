// All-pairs no-gap overlap scores for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel of
// genome_assembly_tpu/ops/overlap_allpairs.py::overlap_scores_block: the
// bodies _kernel_chainrev (the default), _kernel_chain and _kernel. The three
// differ only in how the TPU applies the per-j alignment shift (a shift
// matmul or a lane chain); here the shift is an address offset, so one
// kernel computes the function of all three.
//
// What it computes, for every ordered pair (a_i, b_t):
//   for j = 1 .. len(b_t), with d = min(len(a_i), j):
//     matches(j) = #{u < d : a_i[len(a_i) - d + u] == b_t[j - d + u]}
//     score(j)   = (match - mismatch) * matches(j) + mismatch * d
//   best = first strict maximum over j, starting from score 0 at j = 0.
// Exact int32 arithmetic in ascending j with strict '>', so the TPU's packed
// float32 running max (4*score*1024 + 1023-j) is not needed.
//
// What bounds it on this card: the work is
// sum_pairs sum_j min(len_a, j) base comparisons, about 1.0e12 at
// U = 9,510 reads of 150 bases, against 0.72 GB of int32 output. Counted as
// 3-channel +-1 products (6 ops per comparison, exact in int8) that is
// ~3.0 ms at the int8 tensor-core peak of 1979 TOP/s, against ~0.2 ms for
// the bytes at 3.35 TB/s: the operations bound it. This kernel does them on the integer pipes, not the tensor
// cores, so its practical limit is the issue rate of shared-memory loads and
// popcounts.
//
// What the design does about that:
// - a block stages TM a-rows (right-aligned) and TN b-rows in shared memory
//   as one-hot bytes (A=1, C=2, G=4, T=8, anything else 0), so a 32-bit AND
//   plus one popcount counts the matches of 4 positions;
// - zero bytes before b and before a's suffix act as sentinels: every j
//   then counts exactly ceil(j/4) words for every a-row, with no masks, and
//   the unaligned b window is one funnel shift of two words;
// - one thread per (i, t) output; a warp shares one a-row (its loads are
//   broadcasts) and reads 32 b-rows at an odd word stride (no bank
//   conflicts); the warp's stores of 32 neighbouring outputs coalesce.
// Register tiling, tighter packing and tensor cores are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 32;  // b-rows per block: threadIdx.x
constexpr int TM = 8;   // a-rows per block: threadIdx.y

__device__ __forceinline__ uint8_t one_hot(int8_t c) {
  return (c >= 0 && c < 4) ? static_cast<uint8_t>(1u << c) : 0;
}

__device__ __forceinline__ int clamp_len(int32_t n, int L) {
  return n < 0 ? 0 : (n > L ? L : n);
}

// a, b: (na, L), (nb, L) int8 codes, LEFT-aligned; a_len, b_len: int32.
// a_words = ceil(L/4): a's suffix ends at byte 4*a_words of its row.
// b_words = L/4 + 2: b starts at byte 4, after 4 zero bytes.
// sa, sb: row strides in words (sb odd).
__global__ void __launch_bounds__(TM * TN)
overlap_allpairs_kernel(const int8_t* __restrict__ a,
                        const int32_t* __restrict__ a_len, int na,
                        const int8_t* __restrict__ b,
                        const int32_t* __restrict__ b_len, int nb, int L,
                        int match, int mismatch, int a_words, int sa,
                        int sb, int32_t* __restrict__ score_out,
                        int32_t* __restrict__ end_out) {
  extern __shared__ uint32_t smem[];
  uint32_t* As = smem;            // TM rows of sa words
  uint32_t* Bs = smem + TM * sa;  // TN rows of sb words
  uint8_t* As8 = reinterpret_cast<uint8_t*>(As);
  uint8_t* Bs8 = reinterpret_cast<uint8_t*>(Bs);

  const int i0 = blockIdx.y * TM;
  const int t0 = blockIdx.x * TN;
  const int tid = threadIdx.y * TN + threadIdx.x;
  constexpr int kThreads = TM * TN;

  for (int w = tid; w < TM * sa + TN * sb; w += kThreads) smem[w] = 0;
  __syncthreads();
  for (int idx = tid; idx < TM * L; idx += kThreads) {
    const int r = idx / L, x = idx - r * L;
    const int i = i0 + r;
    if (i < na) {
      const int n = clamp_len(a_len[i], L);
      if (x < n)
        As8[r * sa * 4 + a_words * 4 - n + x] =
            one_hot(a[static_cast<int64_t>(i) * L + x]);
    }
  }
  for (int idx = tid; idx < TN * L; idx += kThreads) {
    const int r = idx / L, x = idx - r * L;
    const int t = t0 + r;
    if (t < nb) {
      const int n = clamp_len(b_len[t], L);
      if (x < n)
        Bs8[r * sb * 4 + 4 + x] = one_hot(b[static_cast<int64_t>(t) * L + x]);
    }
  }
  __syncthreads();

  const int i = i0 + threadIdx.y;
  const int t = t0 + threadIdx.x;
  if (i >= na || t >= nb) return;
  const int n_a = clamp_len(a_len[i], L);
  const int n_b = clamp_len(b_len[t], L);
  const uint32_t* Arow = As + threadIdx.y * sa + a_words - 1;  // last word
  const uint32_t* Brow = Bs + threadIdx.x * sb;
  const int diff = match - mismatch;

  int best = 0, best_j = 0;
  for (int j = 1; j <= n_b; ++j) {
    // Word k of the a-suffix (bytes ending k*4 before its end) lines up
    // with b bytes [j-4k-4, j-4k), i.e. smem bytes [e-4k-4, e-4k) for
    // e = 4 + j: the low word (e >> 2) - 1 - k and its upper neighbour,
    // shifted right by 8 * (j & 3) bits.
    const int w = (4 + j) >> 2;
    const unsigned shift = static_cast<unsigned>(j & 3) * 8u;
    const int chunks = (j + 3) >> 2;
    uint32_t hi = Brow[w];
    int m = 0;
    for (int k = 0; k < chunks; ++k) {
      const uint32_t lo = Brow[w - 1 - k];
      m += __popc(Arow[-k] & __funnelshift_r(lo, hi, shift));
      hi = lo;
    }
    const int s = diff * m + mismatch * min(n_a, j);
    if (s > best) {
      best = s;
      best_j = j;
    }
  }
  const int64_t o = static_cast<int64_t>(i) * nb + t;
  score_out[o] = best;
  end_out[o] = best_j;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of `device` without
// synchronising; returns cudaGetLastError() as an int (0 = launched).
// The caller checks shapes, types, contiguity and na, nb >= 1.
int overlap_allpairs_launch(const void* a, const void* a_len, long long na,
                            const void* b, const void* b_len, long long nb,
                            int L, int match, int mismatch, void* score_out,
                            void* end_out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int a_words = (L + 3) / 4;
  const int sa = a_words;
  const int sb = (L / 4 + 2) | 1;
  const size_t smem = static_cast<size_t>(TM * sa + TN * sb) * 4;
  const dim3 grid(static_cast<unsigned>((nb + TN - 1) / TN),
                  static_cast<unsigned>((na + TM - 1) / TM));
  const dim3 block(TN, TM);
  overlap_allpairs_kernel<<<grid, block, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int32_t*>(a_len),
      static_cast<int>(na), static_cast<const int8_t*>(b),
      static_cast<const int32_t*>(b_len), static_cast<int>(nb), L, match,
      mismatch, a_words, sa, sb, static_cast<int32_t*>(score_out),
      static_cast<int32_t*>(end_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
