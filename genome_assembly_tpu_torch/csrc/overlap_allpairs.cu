// All-pairs no-gap overlap scores for Hopper (sm_90a), written by hand, on
// the tensor cores (wgmma, int8 operands, int32 accumulation).
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
// Codes 0..3 are bases; anything else (PAD, N) matches nothing, as in the
// JAX package's one-hot overlap_scores_block_xla.
//
// What bounds it on this card: the work is
// sum_pairs sum_j min(len_a, j) base comparisons, about 1.0e12 at
// U = 9,510 reads of 150 bases, against 0.72 GB of int32 output. Priced as
// 6 int8 ops per comparison at the 1979 TOP/s int8 tensor-core peak that is
// ~3.0 ms, against ~0.2 ms for the bytes at 3.35 TB/s: the operations bound
// it, and only the tensor cores reach that rate.
//
// What the design does about that:
// - each j is an int8 GEMM. Bases are one-hot words (A, C, G, T in bytes
//   0..3; anything else all zero), so one position is one 32-bit word and
//   M_j[i, t] = sum_u A_j[i, u] . B[t, u] counts the matches of pair (i, t)
//   at j. B is b's prefix, the same for every j; A_j is the window of the
//   right-aligned a that starts at position L - j, sliding one word per j;
// - only the triangle: j runs ceil(j/8) k-steps of 8 positions (32 bytes),
//   up to the block's longest b. Zero positions after each a row make the
//   window exact for u >= j and for rows shorter than j, with no masks;
// - a block has two consumer warpgroups, each owning 64 a-rows against the
//   block's BN b-rows: wgmma.m64nBNk32.s32.u8.u8, B from shared memory
//   (K-major core matrices, no swizzle) through a descriptor, A from
//   registers. A fragment register is one position's 4 channels, built from
//   a byte in shared memory by one shift; two fragment sets alternate so
//   one wgmma is in flight while the next is loaded;
// - BN = 128 while B (BN x 4 x ceil8(L) bytes) and A fit in shared memory
//   (L up to ~350); longer reads take BN = 16;
// - the epilogue keeps one int32 key per output,
//   key = score * 1024 + (1023 - j), updated as max(key, M * D + c_i(j)),
//   D = (match - mismatch) * 1024: max gives the first strict maximum,
//   ties keep the lower j. For 1 <= match - mismatch <= 31, D is folded
//   into the one-hot bytes (8 (match - mismatch) in a's, 128 in b's), so
//   the products are M * D and the update is one DPX instruction per
//   output per j, max(M * D + c, key); other penalties multiply first. No
//   mask: a column's outputs are written at the j that equals its b's
//   length, and later j do not touch them.
//
// What still holds it below the int8 peak (PERF.md): the two warpgroups
// reach each j's drain (wait for the last wgmma) and epilogue together,
// while the tensor cores idle, and a block stages its reads before any
// wgmma. Two warpgroups in step keep the k-loop near the peak; set apart
// in time, each alone feeds the tensor cores too slowly, and the kernel
// was slower. Overlapping the epilogue with the same warpgroup's next
// wgmmas needs a second set of accumulators, which 64 keys and 64
// accumulators a thread leave no registers for.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // a-rows per block: 64 per warpgroup
constexpr int kThreads = 256;  // two warpgroups
constexpr int kPadShift = 32;  // shift byte of a position that matches nothing
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of a block

__device__ __forceinline__ int clamp_len(int32_t n, int L) {
  return n < 0 ? 0 : (n > L ? L : n);
}

// Byte c of the word is v for a base c, the word is 0 for anything else.
__device__ __forceinline__ uint32_t one_hot_word(int8_t c, uint32_t v) {
  return (c >= 0 && c < 4) ? (v << (8 * c)) : 0u;
}

// v << sh for sh < 32, 0 for sh >= 32 (the shift is clamped to 32).
__device__ __forceinline__ uint32_t word_of_shift(uint32_t sh, uint32_t v) {
  return __funnelshift_lc(0u, v, sh);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or reuses of the registers r across
// the asynchronous wgmmas and their waits.
template <typename T, int N>
__device__ __forceinline__ void fence_regs(T (&r)[N]) {
#pragma unroll
  for (int q = 0; q < N; ++q) asm volatile("" : "+r"(r[q])::"memory");
}

// Shared-memory matrix descriptor: K-major, no swizzle. lbo: bytes between
// core matrices adjacent in K; sbo: bytes between 8-row groups.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

template <int N>
struct Mma;

#define D4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define D16(i) D4(i), D4(i + 4), D4(i + 8), D4(i + 12)

template <>
struct Mma<128> {
  static constexpr int kAcc = 64;
  __device__ __forceinline__ static void run(int32_t (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n"
        "}\n"
        : D16(0), D16(16), D16(32), D16(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Mma<16> {
  static constexpr int kAcc = 8;
  __device__ __forceinline__ static void run(int32_t (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.u8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p;\n"
        "}\n"
        : D4(0), D4(4)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

#undef D16
#undef D4

// 16 bytes from p, of which n_left (if under 16) are in bounds; 0 after.
__device__ __forceinline__ uint4 load16(const int8_t* __restrict__ p,
                                        int n_left, bool vec) {
  if (vec && n_left >= 16) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int q = 0; q < 16; ++q)
    if (q < n_left)
      w[q >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + q)))
                   << (8 * (q & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Calls put(row, x, code) for each of the n_bytes codes of rows of width L
// that start at src, reading 16 bytes a thread (vec: src is 16-byte
// aligned), four loads in flight before their codes are placed.
template <typename F>
__device__ __forceinline__ void for_each_code(const int8_t* __restrict__ src,
                                              int n_bytes, int L, bool vec,
                                              F put) {
  const int n_chunks = (n_bytes + 15) / 16;
  for (int k0 = threadIdx.x; k0 < n_chunks; k0 += 4 * kThreads) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u * kThreads;
      v[u] = k < n_chunks ? load16(src + 16 * k, n_bytes - 16 * k, vec)
                          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int off = 16 * (k0 + u * kThreads);
      int r = off / L, x = off - r * L;
      const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        if (off + q < n_bytes)
          put(r, x, static_cast<int8_t>(w[q >> 2] >> (8 * (q & 3))));
        if (++x == L) {
          x = 0;
          ++r;
        }
      }
    }
  }
}

// Shared-memory plan of one block, from L and its BN b-rows.
struct Plan {
  int kp;      // positions of B, a multiple of 8 >= L
  int sab;     // bytes per a-row: >= L + 7, a word count = 4 (mod 8)
  size_t b_bytes, a_bytes, raw_bytes, smem;
};

__host__ __device__ inline Plan make_plan(int L, int bn) {
  Plan p;
  p.kp = (L + 7) / 8 * 8;
  int words = (L + 7 + 3) / 4;
  words += (4 - words % 8 + 8) % 8;
  p.sab = 4 * words;
  p.b_bytes = static_cast<size_t>(bn) * p.kp * 4;
  p.a_bytes = static_cast<size_t>(BM) * p.sab;
  p.raw_bytes = (static_cast<size_t>(bn) * L + 15) / 16 * 16;
  p.smem = p.b_bytes + p.a_bytes + p.raw_bytes +
           static_cast<size_t>(bn + BM + 4) * 4 + (L + 16) / 16 * 16;
  return p;
}

// a, b: (na, L), (nb, L) int8 codes, LEFT-aligned; a_len, b_len: int32.
// One block per tile of BM a-rows by BN b-rows, tiles row-major on grid.x;
// warpgroup w owns the tile's a-rows [64 w, 64 w + 64).
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
overlap_allpairs_kernel(const int8_t* __restrict__ a,
                        const int32_t* __restrict__ a_len, int na,
                        const int8_t* __restrict__ b,
                        const int32_t* __restrict__ b_len, int nb, int L,
                        int match, int mismatch, uint32_t va,
                        uint32_t vb, long long n_tiles_b,
                        int32_t* __restrict__ score_out,
                        int32_t* __restrict__ end_out) {
  constexpr int kAcc = Mma<BN>::kAcc;
  constexpr int kChunks = BN / 8;  // n8 column groups
  extern __shared__ __align__(128) uint8_t smem[];
  const Plan plan = make_plan(L, BN);
  uint8_t* sB = smem;                                 // one-hot, core matrices
  uint8_t* sA = smem + plan.b_bytes;                  // shift bytes, row-major
  int8_t* sBraw = reinterpret_cast<int8_t*>(sA + plan.a_bytes);  // b codes
  int32_t* sLenB = reinterpret_cast<int32_t*>(sBraw + plan.raw_bytes);
  int32_t* sLenA = sLenB + BN;
  int32_t* sJmax = sLenA + BM;                        // max len_b
  uint8_t* sEnds = reinterpret_cast<uint8_t*>(sJmax + 4);  // [j]: a b ends

  const long long tile = blockIdx.x;
  const int i0 = static_cast<int>(tile / n_tiles_b) * BM;
  const int t0 = static_cast<int>(tile % n_tiles_b) * BN;
  const int tid = threadIdx.x;
  const uint32_t lbo = BN * 16;  // bytes between K-adjacent core matrices

  for (int r = tid; r < BM; r += kThreads)
    sLenA[r] = i0 + r < na ? clamp_len(a_len[i0 + r], L) : 0;
  for (int t = tid; t < BN; t += kThreads)
    sLenB[t] = t0 + t < nb ? clamp_len(b_len[t0 + t], L) : 0;
  if (tid == 0) *sJmax = 0;
  for (int j = tid; j <= L; j += kThreads) sEnds[j] = 0;
  const uint32_t pad = kPadShift * 0x01010101u;
  for (size_t k = tid; k < plan.a_bytes / 16; k += kThreads)
    reinterpret_cast<uint4*>(sA)[k] = make_uint4(pad, pad, pad, pad);
  __syncthreads();
  if (tid < BN && t0 + tid < nb) {
    atomicMax(sJmax, sLenB[tid]);
    sEnds[sLenB[tid]] = 1;
  }
  // The tile's rows are contiguous in device memory, and start on a
  // 16-byte boundary whenever the tensors do.
  const bool vec =
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
       15) == 0;
  // B: first the tile's codes as they lie in device memory.
  const int b_bytes = min(nb - t0, BN) * L;
  const int8_t* b_tile = b + static_cast<long long>(t0) * L;
  for (int k = tid; 16 * k < b_bytes; k += kThreads)
    reinterpret_cast<uint4*>(sBraw)[k] =
        load16(b_tile + 16 * k, b_bytes - 16 * k, vec);
  // A: byte p of row r is the shift of right-aligned position p's one-hot
  // word (8 * code), or kPadShift before the read, after it and past na.
  for_each_code(a + static_cast<long long>(i0) * L, min(na - i0, BM) * L, L,
                vec, [&](int r, int x, int8_t c) {
                  const int n = sLenA[r];
                  if (x < n && c >= 0 && c < 4)
                    sA[r * plan.sab + L - n + x] = static_cast<uint8_t>(8 * c);
                });
  __syncthreads();
  // Then B one-hot: row t, positions 4c..4c+3 form one 16-byte row of core
  // matrix (t / 8, c); core matrices adjacent in t are 128 B apart, in c
  // lbo B. Threads take consecutive t, so a warp's stores fill 512
  // contiguous bytes (consecutive c would all hit one bank).
  for (int idx = tid; idx < BN * (plan.kp / 4); idx += kThreads) {
    const int t = idx % BN, c = idx / BN;
    const int n = sLenB[t];
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = 4 * c + q < n ? one_hot_word(sBraw[t * L + 4 * c + q], vb) : 0u;
    *reinterpret_cast<uint4*>(sB + c * lbo + (t >> 3) * 128 + (t & 7) * 16) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  __syncthreads();

  const int wg = tid / 128;
  const int lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = wg * 64 + ((tid & 127) >> 5) * 16 + g;  // and row0 + 8
  const int col0 = 2 * tig;                                // + 8c, and + 1
  const int la0 = sLenA[row0], la1 = sLenA[row0 + 8];
  const uint8_t* ar0 = sA + row0 * plan.sab + tig;
  const uint8_t* ar1 = ar0 + 8 * plan.sab;
  const int j_max = *sJmax;
  // the products are M * va * vb; D brings them to M * (match - mismatch)
  // * 1024, and is 1 when va * vb is that factor already
  const int D = (match - mismatch) * 1024 / static_cast<int>(va * vb);
  const uint64_t desc0 = make_desc(
      static_cast<uint32_t>(__cvta_generic_to_shared(sB)), lbo, 128);
  const uint64_t desc_step = (2 * lbo) >> 4;  // one k-step: 2 core matrices

  int32_t acc[kAcc];
  int32_t key[kAcc];
#pragma unroll
  for (int q = 0; q < kAcc; ++q) {
    acc[q] = 0;
    key[q] = 1023;  // score 0 at j = 0
  }
  uint32_t fa[4] = {0u, 0u, 0u, 0u}, fb[4] = {0u, 0u, 0u, 0u};

  // Writes the outputs of the owned columns whose b has length n; a b of
  // length 0 scores 0 at j = 0.
  const bool pair_stores = (nb & 1) == 0;  // 8-byte aligned column pairs
  auto store_ended = [&](int n) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int t = t0 + col0 + 8 * c;
      const int2 lb = *reinterpret_cast<const int2*>(sLenB + col0 + 8 * c);
      const bool e0 = lb.x == n && t < nb, e1 = lb.y == n && t + 1 < nb;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + row0 + 8 * h;
        if (i >= na || !(e0 || e1)) continue;
        const int k0 = n ? key[4 * c + 2 * h] : 1023;
        const int k1 = n ? key[4 * c + 2 * h + 1] : 1023;
        const long long o = static_cast<long long>(i) * nb + t;
        if (e0 && e1 && pair_stores) {
          *reinterpret_cast<int2*>(score_out + o) = make_int2(k0 >> 10, k1 >> 10);
          *reinterpret_cast<int2*>(end_out + o) =
              make_int2(1023 - (k0 & 1023), 1023 - (k1 & 1023));
        } else {
          if (e0) {
            score_out[o] = k0 >> 10;
            end_out[o] = 1023 - (k0 & 1023);
          }
          if (e1) {
            score_out[o + 1] = k1 >> 10;
            end_out[o + 1] = 1023 - (k1 & 1023);
          }
        }
      }
    }
  };

  for (int j = 1; j <= j_max; ++j) {
    const int ks = (j + 7) >> 3;
    auto load = [&](uint32_t (&f)[4], int s) {
      const int p = L - j + 8 * s;
      f[0] = word_of_shift(ar0[p], va);
      f[1] = word_of_shift(ar1[p], va);
      f[2] = word_of_shift(ar0[p + 4], va);
      f[3] = word_of_shift(ar1[p + 4], va);
    };
    fence_regs(acc);
    int s = 0;
    while (true) {
      load(fa, s);
      wgmma_fence();
      Mma<BN>::run(acc, fa, desc0 + desc_step * s, s);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(fb);  // its wgmma, the one before, is complete
      if (++s == ks) break;
      load(fb, s);
      wgmma_fence();
      Mma<BN>::run(acc, fb, desc0 + desc_step * s, 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(fa);
      if (++s == ks) break;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(fa);
    fence_regs(fb);

    // c(j) = mismatch * min(len_a, j) * 1024 + 1023 - j, per owned row
    const int c0 = mismatch * min(la0, j) * 1024 + 1023 - j;
    const int c1 = mismatch * min(la1, j) * 1024 + 1023 - j;
    if (D == 1) {
#pragma unroll
      for (int q = 0; q < kAcc; ++q)  // one DPX instruction: max(a + b, c)
        key[q] = __viaddmax_s32(acc[q], (q & 2) ? c1 : c0, key[q]);
    } else {
#pragma unroll
      for (int q = 0; q < kAcc; ++q)
        key[q] = max(key[q], acc[q] * D + ((q & 2) ? c1 : c0));
    }
    if (sEnds[j]) store_ended(j);
  }
  store_ended(0);
}

template <int BN>
cudaError_t launch(const void* a, const void* a_len, long long na,
                   const void* b, const void* b_len, long long nb, int L,
                   int match, int mismatch, void* score_out, void* end_out,
                   cudaStream_t stream) {
  const Plan plan = make_plan(L, BN);
  // Fold the epilogue's factor (match - mismatch) * 1024 into the one-hot
  // bytes when it splits into two bytes, 8 (match - mismatch) in a's and
  // 128 in b's: the epilogue is then one max(M + c, key) a output.
  const int diff = match - mismatch;
  const bool fold = diff >= 1 && diff <= 31;
  const uint32_t va = fold ? 8 * diff : 1, vb = fold ? 128 : 1;
  cudaError_t err = cudaFuncSetAttribute(
      overlap_allpairs_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.smem));
  if (err != cudaSuccess) return err;
  const long long n_tiles_b = (nb + BN - 1) / BN;
  const long long n_tiles = (na + BM - 1) / BM * n_tiles_b;
  overlap_allpairs_kernel<BN><<<static_cast<unsigned>(n_tiles), kThreads,
                                plan.smem, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int32_t*>(a_len),
      static_cast<int>(na), static_cast<const int8_t*>(b),
      static_cast<const int32_t*>(b_len), static_cast<int>(nb), L, match,
      mismatch, va, vb, n_tiles_b, static_cast<int32_t*>(score_out),
      static_cast<int32_t*>(end_out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of `device` without
// synchronising; returns a cudaError_t as an int (0 = launched).
// The caller checks shapes, types, contiguity, na, nb >= 1, L <= 1023, the
// int32 range of the key and that the number of tiles fits grid.x.
int overlap_allpairs_launch(const void* a, const void* a_len, long long na,
                            const void* b, const void* b_len, long long nb,
                            int L, int match, int mismatch, void* score_out,
                            void* end_out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (make_plan(L, 128).smem <= kMaxSmem)
    err = launch<128>(a, a_len, na, b, b_len, nb, L, match, mismatch,
                     score_out, end_out, s);
  else
    err = launch<16>(a, a_len, na, b, b_len, nb, L, match, mismatch,
                     score_out, end_out, s);
  return static_cast<int>(err);
}

}  // extern "C"
