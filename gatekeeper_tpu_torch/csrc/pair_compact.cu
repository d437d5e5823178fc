// K1: pair compaction of bit-packed verdicts on Hopper (sm_90a).
//
// Replaces the JAX package's _pair_expand (gatekeeper_tpu/ir/evaljax.py,
// fed by _pairs_jit and _slab_pairs_jit): masked verdict words
// packed[R, W] (bit b of word w = constraint 32w+b) become one int32 block
// out[pcap+1, 2]. Row 0 holds the true pair count, which may exceed pcap
// (the host retries at a larger capacity); rows 1.. hold (row0 + r, col)
// in row-major order, zero past the count.
//
// Bound: bytes. The kernel reads R*W*4 bytes of words once for the count
// and once more for the walk (the second read is mostly L2 hits at the
// slab sizes the audit uses) and writes 8 bytes per emitted pair; there is
// no arithmetic to speak of. Audit verdicts are ~99% zero, so the walk
// touches few bits.
//
// Design, simple and order-preserving:
//   1. count_rows: one thread per row, masked popcount over its W words.
//   2. scan_counts: one block turns the counts into exclusive offsets in
//      place (each thread scans a contiguous run serially, then the block
//      scans the run totals) and writes the header.
//   3. emit_pairs: one thread per row walks its words and bits in
//      ascending order and writes each pair at its offset while the offset
//      is below pcap; the same grid zero-fills the body past the count.
// Every output row is written by exactly one thread, so the result does
// not depend on scheduling.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 1024;

__device__ __forceinline__ uint32_t col_mask(int w, int c) {
  // bits of word w whose column 32w+b is below c
  int lo = 32 * w;
  if (c >= lo + 32) return 0xffffffffu;
  if (c <= lo) return 0u;
  return (1u << (c - lo)) - 1u;
}

__global__ void count_rows(const uint32_t* __restrict__ packed, int R, int W,
                           int r_begin, int r_end, int c,
                           int* __restrict__ counts) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  int n = 0;
  if (r >= r_begin && r < r_end) {
    const uint32_t* row = packed + (size_t)r * W;
    for (int w = 0; w < W; ++w) n += __popc(row[w] & col_mask(w, c));
  }
  counts[r] = n;
}

__global__ void scan_counts(int* __restrict__ counts, int R,
                            int* __restrict__ out) {
  __shared__ int part[kScanThreads];
  int t = threadIdx.x;
  int per = (R + kScanThreads - 1) / kScanThreads;
  int lo = t * per;
  int hi = min(lo + per, R);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += counts[i];
  part[t] = s;
  __syncthreads();
  // Hillis-Steele inclusive scan over the run totals
  for (int d = 1; d < kScanThreads; d <<= 1) {
    int v = (t >= d) ? part[t - d] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = part[t] - s;  // exclusive offset of this thread's run
  for (int i = lo; i < hi; ++i) {
    int v = counts[i];
    counts[i] = run;
    run += v;
  }
  if (t == kScanThreads - 1) {
    out[0] = part[t];
    out[1] = 0;
  }
}

__global__ void emit_pairs(const uint32_t* __restrict__ packed, int R, int W,
                           int r_begin, int r_end, int row0, int c, int pcap,
                           const int* __restrict__ offsets,
                           int* __restrict__ out) {
  int stride = gridDim.x * blockDim.x;
  int first = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = first; i < R; i += stride) {
    if (i < r_begin || i >= r_end) continue;
    int off = offsets[i];
    const uint32_t* row = packed + (size_t)i * W;
    for (int w = 0; w < W && off < pcap; ++w) {
      uint32_t word = row[w] & col_mask(w, c);
      while (word != 0u && off < pcap) {
        int b = __ffs(word) - 1;
        out[2 * (1 + off)] = row0 + i;
        out[2 * (1 + off) + 1] = 32 * w + b;
        ++off;
        word &= word - 1u;
      }
    }
  }
  int total = out[0];
  for (int j = first; j < pcap; j += stride) {
    if (j >= total) {
      out[2 * (1 + j)] = 0;
      out[2 * (1 + j) + 1] = 0;
    }
  }
}

}  // namespace

extern "C" int pair_compact(const void* packed, int R, int W, int r_begin,
                            int r_end, int row0, int c, int pcap,
                            void* scratch, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(packed);
  int* counts = static_cast<int*>(scratch);
  int* o = static_cast<int*>(out);
  const int threads = 256;
  int rows = R > 0 ? R : 1;
  count_rows<<<(rows + threads - 1) / threads, threads, 0, s>>>(
      p, R, W, r_begin, r_end, c, counts);
  scan_counts<<<1, kScanThreads, 0, s>>>(counts, R, o);
  int span = rows > pcap ? rows : pcap;
  int blocks = (span + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  emit_pairs<<<blocks, threads, 0, s>>>(p, R, W, r_begin, r_end, row0, c,
                                        pcap, counts, o);
  return static_cast<int>(cudaGetLastError());
}
