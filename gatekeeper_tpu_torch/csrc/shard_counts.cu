// K6: masked per-constraint counts of bit-packed verdicts on Hopper
// (sm_90a).
//
// Replaces the compute half of the JAX package's audit step
// (gatekeeper_tpu/parallel/collectives.py make_audit_step: the
// jnp.sum(fires & row_mask, axis=0, dtype=int32) each data shard takes
// before the psum over "data"), taken over PACKED verdict words:
// packed[R, W] (bit b of word w = constraint 32w+b), rows outside
// [r_begin, r_end) masked (padding rows past n_valid), columns >= c
// masked (C-bucket padding). out[C] int32 receives the count of set bits
// per column j < min(c, C, 32W); with `accumulate` the counts add into
// out (shards that share a card sum into one tensor with no extra
// launch), else out is cleared first (cudaMemsetAsync) and columns at or
// past min(c, 32W) stay 0. The psum's cross-card half is not a kernel:
// the wrapper's caller sums per-card partials (parallel/collectives.py).
//
// Bound: bytes. The words are read once (R*W*4 bytes) and C*4 bytes are
// written; the work per word is 32 shift-and-adds. At an audit shard's
// [32768, 16] that is 2 MB, under a microsecond of HBM time, so the
// launch itself sets the time.
//
// Design: grid (row tiles, word tiles of up to kWordTile words). A block
// of 256 threads splits into row lanes of nw threads, thread t taking
// word t % nw of rows lane, lane + lanes, ... of its tile (a warp reads
// whole rows, contiguous), and keeps its word's 32 column counts in
// registers (fully unrolled, constant indices). The lanes then fold
// into shared memory (one shared atomic per nonzero counter), and the
// block adds each nonzero column total to out with one global atomic.
// Integer adds commute, so the result does not depend on the order in
// which blocks or lanes run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordTile = 32;  // words per block: 1,024 columns

__device__ __forceinline__ uint32_t col_mask(int w, int c) {
  // bits of word w whose column 32w+b is below c
  int lo = 32 * w;
  if (c >= lo + 32) return 0xffffffffu;
  if (c <= lo) return 0u;
  return (1u << (c - lo)) - 1u;
}

__global__ void __launch_bounds__(kThreads)
shard_counts_kernel(const uint32_t* __restrict__ packed, int R, int W,
                    int r_lo, int r_hi, int c, int C, int rows_per_tile,
                    int* __restrict__ out) {
  __shared__ unsigned int tot[kWordTile * 32];
  int w0 = blockIdx.y * kWordTile;
  int nw = min(kWordTile, W - w0);
  int lanes = kThreads / nw;
  int lane = threadIdx.x / nw;
  int w = w0 + threadIdx.x % nw;
  for (int j = threadIdx.x; j < nw * 32; j += kThreads) tot[j] = 0;
  __syncthreads();
  int t0 = max(r_lo, blockIdx.x * rows_per_tile);
  int t1 = min(r_hi, (blockIdx.x + 1) * rows_per_tile);
  if (lane < lanes) {
    uint32_t mask = col_mask(w, c);
    unsigned int cnt[32];
#pragma unroll
    for (int b = 0; b < 32; ++b) cnt[b] = 0;
    for (int r = t0 + lane; r < t1; r += lanes) {
      uint32_t x = __ldg(packed + (size_t)r * W + w) & mask;
      if (x) {
#pragma unroll
        for (int b = 0; b < 32; ++b) cnt[b] += (x >> b) & 1u;
      }
    }
#pragma unroll
    for (int b = 0; b < 32; ++b)
      if (cnt[b]) atomicAdd(&tot[(w - w0) * 32 + b], cnt[b]);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nw * 32; j += kThreads) {
    int col = w0 * 32 + j;
    if (col < C && tot[j]) atomicAdd(out + col, (int)tot[j]);
  }
}

}  // namespace

// Returns the cudaError_t of the memset or the launch (0 = queued).
extern "C" int shard_counts(const void* packed, int R, int W, int r_begin,
                            int r_end, int c, int C, int rows_per_tile,
                            int tiles, int accumulate, void* out,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!accumulate && C > 0) {
    cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)C, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int r_lo = r_begin < 0 ? 0 : r_begin;
  int r_hi = r_end > R ? R : r_end;
  int cc = c < 32 * W ? c : 32 * W;
  if (cc > C) cc = C;
  if (r_hi <= r_lo || cc <= 0 || tiles <= 0) return 0;
  dim3 grid(tiles, (W + kWordTile - 1) / kWordTile);
  shard_counts_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(packed), R, W, r_lo, r_hi, cc, C,
      rows_per_tile, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
