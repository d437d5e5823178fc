// K1: pair compaction of bit-packed verdicts on Hopper (sm_90a).
//
// Replaces the JAX package's _pair_expand (gatekeeper_tpu/ir/evaljax.py,
// fed by _pairs_jit and _slab_pairs_jit): masked verdict words
// packed[R, W] (bit b of word w = constraint 32w+b) become one int32 block
// out[pcap+1, 2]. Row 0 holds the true pair count, which may exceed pcap
// (the host retries at a larger capacity); rows 1.. hold (row0 + r, col)
// in row-major order, zero past the count.
//
// Bound: bytes. The words are read once from device memory (R*W*4 bytes;
// the second pass re-reads them from the 50 MB L2) and each pair is
// written once (8 bytes); there is no arithmetic to speak of. Audit
// verdicts are ~99% zero, so the emit walk touches few bits.
//
// Design: two launches over the same tiles of rows, no serial scan.
//   1. tile_counts: each block takes a tile of TILE = 256 * rpt rows, one
//      row per thread per pass; a thread reads its row's words with
//      16-byte loads (when W is a multiple of 4 and the base is aligned),
//      masks the columns >= c and the rows outside [r_begin, r_end), and
//      popcounts; the block reduces to its tile's count. The loads are
//      per row, not coalesced across a warp (lanes W * 4 bytes apart):
//      reading each tile as one flat run of words instead, a warp's
//      16-byte loads contiguous and the per-row counts gathered by
//      shared-memory atomics, measured slower on the H100 at the audit's
//      [57344, 16] (PERF.md), where the two launches' gaps set the time.
//   2. emit_tiles: each block sums the tile counts before its own (its
//      global offset) and all of them (the total: block 0 writes the
//      header), recounts its rows from L2, turns them into offsets with a
//      warp-shuffle block scan pass by pass, and writes each row's pairs
//      in ascending column order while the offset is below pcap. Then the
//      grid zero-fills the body rows [total, pcap).
// Every output row is written by exactly one thread, from offsets that
// are prefix sums of the counts, so the block does not depend on how the
// blocks are scheduled. The wrapper sizes rpt so that there are at most
// kMaxTiles tiles (each block of pass 2 reads every tile count once).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t col_mask(int w, int c) {
  // bits of word w whose column 32w+b is below c
  int lo = 32 * w;
  if (c >= lo + 32) return 0xffffffffu;
  if (c <= lo) return 0u;
  return (1u << (c - lo)) - 1u;
}

__device__ __forceinline__ int row_count(const uint32_t* __restrict__ row,
                                         int W, int c, bool vec4) {
  int n = 0;
  if (vec4) {
    const uint4* v = reinterpret_cast<const uint4*>(row);
    for (int q = 0; q < W / 4; ++q) {
      uint4 x = __ldg(v + q);
      int w = 4 * q;
      n += __popc(x.x & col_mask(w, c)) + __popc(x.y & col_mask(w + 1, c)) +
           __popc(x.z & col_mask(w + 2, c)) + __popc(x.w & col_mask(w + 3, c));
    }
  } else {
    for (int w = 0; w < W; ++w) n += __popc(__ldg(row + w) & col_mask(w, c));
  }
  return n;
}

__device__ __forceinline__ int in_range(int r, int R, int r_begin,
                                        int r_end) {
  return r < R && r >= r_begin && r < r_end;
}

// block-wide sum; every thread gets the result
__device__ __forceinline__ long long block_sum(long long v,
                                               long long* smem) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  long long s = 0;
  for (int i = 0; i < kWarps; ++i) s += smem[i];
  return s;
}

// block-wide exclusive scan of v in thread order; *total gets the sum
__device__ __forceinline__ int block_excl_scan(int v, int* smem,
                                               int* total) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  __syncthreads();
  if (lane == 31) smem[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
  for (int i = 0; i < kWarps; ++i) {
    int s = smem[i];
    if (i < warp) before += s;
    all += s;
  }
  *total = all;
  return before + x - v;
}

__global__ void __launch_bounds__(kThreads)
tile_counts(const uint32_t* __restrict__ packed, int R, int W, int r_begin,
            int r_end, int c, int rpt, bool vec4,
            int* __restrict__ tile_sum) {
  __shared__ long long red[kWarps];
  int base = blockIdx.x * kThreads * rpt;
  long long n = 0;
  for (int k = 0; k < rpt; ++k) {
    int r = base + k * kThreads + threadIdx.x;
    if (in_range(r, R, r_begin, r_end))
      n += row_count(packed + (size_t)r * W, W, c, vec4);
  }
  long long s = block_sum(n, red);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = static_cast<int>(s);
}

__global__ void __launch_bounds__(kThreads)
emit_tiles(const uint32_t* __restrict__ packed, int R, int W, int r_begin,
           int r_end, int row0, int c, int pcap, int rpt, bool vec4,
           const int* __restrict__ tile_sum, int tiles,
           int* __restrict__ out) {
  __shared__ long long red[kWarps];
  __shared__ int scan[kWarps];
  // this tile's global offset and the total, from the tile counts
  long long before = 0, all = 0;
  for (int i = threadIdx.x; i < tiles; i += kThreads) {
    int s = tile_sum[i];
    all += s;
    if (i < (int)blockIdx.x) before += s;
  }
  long long off = block_sum(before, red);
  long long total = block_sum(all, red);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    out[0] = static_cast<int>(total);
    out[1] = 0;
  }
  int base = blockIdx.x * kThreads * rpt;
  for (int k = 0; k < rpt && off < pcap; ++k) {
    int r = base + k * kThreads + threadIdx.x;
    bool live = in_range(r, R, r_begin, r_end);
    const uint32_t* row = packed + (size_t)r * W;
    int n = live ? row_count(row, W, c, vec4) : 0;
    int pass_total;
    long long o = off + block_excl_scan(n, scan, &pass_total);
    if (n > 0 && o < pcap) {
      int* dst = out + 2 * (1 + o);
      for (int w = 0; w < W && o < pcap; ++w) {
        uint32_t word = __ldg(row + w) & col_mask(w, c);
        while (word != 0u && o < pcap) {
          int b = __ffs(word) - 1;
          reinterpret_cast<int2*>(dst)[0] = make_int2(row0 + r, 32 * w + b);
          dst += 2;
          ++o;
          word &= word - 1u;
        }
      }
    }
    off += pass_total;
  }
  // the body past the count: rows [total, pcap), grid-strided
  long long stride = (long long)gridDim.x * kThreads;
  for (long long j = total + (long long)blockIdx.x * kThreads + threadIdx.x;
       j < pcap; j += stride)
    reinterpret_cast<int2*>(out + 2 * (1 + j))[0] = make_int2(0, 0);
}

}  // namespace

// scratch: `tiles` ints of tile counts (allocated by the caller)
extern "C" int pair_compact(const void* packed, int R, int W, int r_begin,
                            int r_end, int row0, int c, int pcap, int rpt,
                            int tiles, int vec4, void* scratch, void* out,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(packed);
  int* tile_sum = static_cast<int*>(scratch);
  int* o = static_cast<int*>(out);
  tile_counts<<<tiles, kThreads, 0, s>>>(p, R, W, r_begin, r_end, c, rpt,
                                         vec4 != 0, tile_sum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  emit_tiles<<<tiles, kThreads, 0, s>>>(p, R, W, r_begin, r_end, row0, c,
                                        pcap, rpt, vec4 != 0, tile_sum,
                                        tiles, o);
  return static_cast<int>(cudaGetLastError());
}
