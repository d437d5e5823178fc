// K6: the audit step's per-shard epilogue on Hopper (sm_90a), one launch:
// the masked verdict block as bool into the step's fires, and the
// block's per-constraint counts.
//
// Replaces what the JAX package's audit step does after eval_fn on each
// shard (gatekeeper_tpu/parallel/collectives.py make_audit_step's
// `local`: fires & row_mask, then jnp.sum(fires, axis=0, dtype=int32)
// before the psum over "data"), taken over PACKED verdict words:
// packed[R, W] (bit b of word w = constraint 32w+b). Rows outside
// [r_begin, r_end) are masked (padding rows past n_valid), and so are
// columns >= c (C-bucket padding). One launch
//   * writes fires[r, j] = the masked bit, as a byte 0 or 1, for every
//     row r < R and column j < F (F <= 32W): a strided destination
//     (`ld` bytes between rows, any byte offset), so that a shard writes
//     its block of the step's [N, C] fires in place;
//   * adds into out[j] the number of rows in the range whose bit j is
//     set, for j < min(c, C, 32W). The kernel only adds: the caller
//     zeroes each device's partial once a step, and the shards one card
//     holds sum into it.
// The psum's cross-card half is not a kernel: the wrapper's caller sums
// per-card partials (parallel/collectives.py).
//
// Bound: bytes. R*W*4 read, R*F written, C*4 added; at an audit shard's
// [32768, 16] words with F = c = 500 that is 18.5 MB.
//
// Design: grid (row tiles, word tiles of up to kWordTile words). A block
// of 256 threads walks its row tile kSubRows rows at a time:
//   1. stage: the sub-tile's words, read whole rows at a time (coalesced),
//      masked by row and column, into shared memory (row stride
//      kWordTile + 1 words: no bank conflict when lanes take rows);
//   2. count: each warp takes words of the tile; for 32 rows at a time,
//      lane i holds row i's word, the warp transposes the 32x32 bit block
//      in registers (5 rounds of __shfl_xor_sync), and lane b adds the
//      popcount of column b's 32 row bits to its register counter (a
//      block of 32 rows with no bit set is skipped);
//   3. write: each thread takes one whole 16-byte-aligned chunk of a
//      row's destination bytes, builds its 16 bits from the row's words
//      (a 64-bit window of two words), expands them to 16 bytes (4 bits
//      per 32-bit word by one multiply) and stores them with one 16-byte
//      store; consecutive threads write consecutive chunks of a row.
//      Then the bytes the row's first and last columns cut off a chunk
//      (the destination's row offset is arbitrary: at most 15 at each
//      end) are written by two threads a row, in a pass of their own so
//      that no warp of the chunk pass diverges, each end in at most four
//      aligned stores of 8, 4, 2 or 1 bytes.
// After the tile, each lane adds its nonzero counters to out with one
// global atomic per column per block. Integer adds commute, so the
// counts do not depend on the order in which blocks run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWordTile = 32;          // words per block: 1,024 columns
constexpr int kSubRows = 32;           // rows staged at a time
constexpr int kStride = kWordTile + 1; // shared row stride (words)
constexpr int kWordsPerWarp = kWordTile / kWarps;

__device__ __forceinline__ uint32_t col_mask(int w, int c) {
  // bits of word w whose column 32w+b is below c
  int lo = 32 * w;
  if (c >= lo + 32) return 0xffffffffu;
  if (c <= lo) return 0u;
  return (1u << (c - lo)) - 1u;
}

// Lane i holds row i of a 32x32 bit block (bit b = column b); returns
// column `lane` of it (bit i = row i).
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  const uint32_t masks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    int j = 16 >> s;
    uint32_t m = masks[s];
    uint32_t y = __shfl_xor_sync(0xffffffffu, x, j);
    x = (lane & j) ? ((x & ~m) | ((y & ~m) >> j))
                   : ((x & m) | ((y & m) << j));
  }
  return x;
}

// 4 bits -> 4 bytes of 0 or 1 (bit i to byte i)
__device__ __forceinline__ uint32_t expand4(uint32_t b) {
  return ((b & 0xfu) * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(kThreads)
shard_epilogue_kernel(const uint32_t* __restrict__ packed, int R, int W,
                      int r_lo, int r_hi, int cc, int C, int rows_per_tile,
                      uint8_t* __restrict__ fires, long long ld, int F,
                      int* __restrict__ out) {
  __shared__ uint32_t tile[kSubRows * kStride];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w0 = blockIdx.y * kWordTile;
  const int nw = min(kWordTile, W - w0);
  const int col0 = 32 * w0;                      // first column of the tile
  const int col1 = min(F, col0 + 32 * nw);       // its destination's end
  const int ncols = max(0, col1 - col0);
  const int nch = ncols / 16;  // whole chunks a row can hold, at most
  const float inv_nch = nch > 0 ? 1.0f / (float)nch : 0.0f;
  const int t0 = blockIdx.x * rows_per_tile;
  const int t1 = min(R, t0 + rows_per_tile);
  uint32_t cnt[kWordsPerWarp];
#pragma unroll
  for (int k = 0; k < kWordsPerWarp; ++k) cnt[k] = 0;

  for (int s0 = t0; s0 < t1; s0 += kSubRows) {
    const int ns = min(kSubRows, t1 - s0);
    __syncthreads();  // the previous sub-tile's readers are done
    for (int i = threadIdx.x; i < ns * nw; i += kThreads) {
      int r = i / nw, w = i - r * nw;
      int row = s0 + r;
      uint32_t x = 0;
      if (row >= r_lo && row < r_hi)
        x = __ldg(packed + (size_t)row * W + w0 + w) & col_mask(w0 + w, cc);
      tile[r * kStride + w] = x;
    }
    __syncthreads();

    // counts: 32 rows x 1 word per transpose
#pragma unroll
    for (int k = 0; k < kWordsPerWarp; ++k) {
      int wi = warp + kWarps * k;
      if (wi < nw) {
        for (int g = 0; g < ns; g += 32) {
          uint32_t x = (g + lane < ns) ? tile[(g + lane) * kStride + wi] : 0u;
          if (__any_sync(0xffffffffu, x != 0u))
            cnt[k] += __popc(transpose32(x, lane));
        }
      }
    }

    // writes, 1: the whole 16-byte-aligned chunks of each row's
    // destination bytes [a, e), from ru = a rounded up to 16 to rd = e
    // rounded down; r and k by a float reciprocal (exact at these sizes)
    for (int i = threadIdx.x; i < ns * nch; i += kThreads) {
      int r = (int)(((float)i + 0.5f) * inv_nch);
      int k = i - r * nch;
      uintptr_t a = reinterpret_cast<uintptr_t>(fires) +
                    (uintptr_t)((long long)(s0 + r) * ld) + col0;
      uintptr_t ru = (a + 15) & ~uintptr_t(15);
      uintptr_t A = ru + 16 * (uintptr_t)k;
      if (A + 16 > a + ncols) continue;
      int jl = (int)(A - a);  // tile column of the chunk's first byte
      const uint32_t* trow = tile + r * kStride;
      int wl = jl >> 5, sh = jl & 31;
      uint64_t lo = trow[wl];
      uint64_t hi = wl + 1 < nw ? trow[wl + 1] : 0u;
      uint32_t bits = (uint32_t)(((hi << 32) | lo) >> sh) & 0xffffu;
      *reinterpret_cast<uint4*>(A) =
          make_uint4(expand4(bits), expand4(bits >> 4), expand4(bits >> 8),
                     expand4(bits >> 12));
    }
    // writes, 2: the bytes a row's ends cut off a chunk (at most 15 at
    // each end), two threads a row: the head [a, min(ru, e)) and the tail
    // [max(rd, ru), e), each in at most 4 aligned stores of 1-8 bytes
    for (int i = threadIdx.x; i < (ncols > 0 ? ns * 2 : 0); i += kThreads) {
      int r = i >> 1;
      uintptr_t a = reinterpret_cast<uintptr_t>(fires) +
                    (uintptr_t)((long long)(s0 + r) * ld) + col0;
      uintptr_t e = a + ncols;
      uintptr_t ru = (a + 15) & ~uintptr_t(15);
      uintptr_t rd = e & ~uintptr_t(15);
      uintptr_t B = (i & 1) ? (rd > ru ? rd : ru) : ru - 16;  // chunk
      uintptr_t p = (i & 1) ? B : a;
      uintptr_t q = (i & 1) ? e : (ru < e ? ru : e);
      if (p >= q) continue;
      // the chunk's 16 bytes: columns jl .. jl+15 (jl >= -15)
      int jl = (int)((long long)B - (long long)a);
      int wl = jl >> 5, sh = jl & 31;  // floor
      const uint32_t* trow = tile + r * kStride;
      uint64_t lo = (wl >= 0 && wl < nw) ? trow[wl] : 0u;
      uint64_t hi = (wl + 1 >= 0 && wl + 1 < nw) ? trow[wl + 1] : 0u;
      uint32_t bits = (uint32_t)(((hi << 32) | lo) >> sh) & 0xffffu;
      uint64_t v0 = expand4(bits) | ((uint64_t)expand4(bits >> 4) << 32);
      uint64_t v1 = expand4(bits >> 8) | ((uint64_t)expand4(bits >> 12) << 32);
      for (int o = (int)(p - B), end = (int)(q - B); o < end;) {
        int n = (o & 1) ? 1 : (o & 2) ? 2 : (o & 4) ? 4 : 8;
        while (o + n > end) n >>= 1;
        uint64_t x = (o < 8 ? v0 : v1) >> (8 * (o & 7));
        void* dst = reinterpret_cast<void*>(B + o);
        if (n == 8) *static_cast<uint64_t*>(dst) = x;
        else if (n == 4) *static_cast<uint32_t*>(dst) = (uint32_t)x;
        else if (n == 2) *static_cast<uint16_t*>(dst) = (uint16_t)x;
        else *static_cast<uint8_t*>(dst) = (uint8_t)x;
        o += n;
      }
    }
  }

  const int climit = min(cc, C);
#pragma unroll
  for (int k = 0; k < kWordsPerWarp; ++k) {
    int wi = warp + kWarps * k;
    int col = 32 * (w0 + wi) + lane;
    if (wi < nw && col < climit && cnt[k])
      atomicAdd(out + col, (int)cnt[k]);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = queued).
extern "C" int shard_counts(const void* packed, int R, int W, int r_begin,
                            int r_end, int c, void* fires, long long ld,
                            int F, void* out, int C, int rows_per_tile,
                            int tiles, void* stream) {
  int r_lo = r_begin < 0 ? 0 : r_begin;
  int r_hi = r_end > R ? R : r_end;
  int cc = c < 32 * W ? c : 32 * W;
  if (cc < 0) cc = 0;
  if (R <= 0 || W <= 0 || tiles <= 0) return 0;
  dim3 grid(tiles, (W + kWordTile - 1) / kWordTile);
  shard_epilogue_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), R, W, r_lo, r_hi, cc, C,
      rows_per_tile, static_cast<uint8_t*>(fires), ld, F,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
