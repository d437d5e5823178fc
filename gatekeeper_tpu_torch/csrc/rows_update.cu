// K5: resident feature-row scatter on Hopper (sm_90a).
//
// Replaces the JAX package's row-patch program
// (gatekeeper_tpu/ir/driver.py, TpuDriver._dev_patch_rows's `upd`:
// d.at[p].set(r), one dispatch per feature leaf). Here one launch patches
// every leaf of a kind: for each leaf l and each dirty row i < m,
//   dst_l[pos[i]] = rows_l[i]
// copied as raw bytes, so the leaf's dtype does not matter (int8, int32,
// float32 with its NaN payloads, uint32 as its int32 view).
//
// Everything the kernel reads arrives in ONE staged device buffer, copied
// from one pinned host buffer by the wrapper (kernels/rows_update.py):
//   [0, 32 L)              L leaf descriptors (LeafDesc below);
//   [pos_off, +4 m)        pos[m] int32, the destination row of each i;
//   [src_off_l, +m R_l)    leaf l's m rows back to back, R_l bytes each,
//                          src_off_l a multiple of 16.
//
// Bound: bytes. The function reads the m R_l staged bytes of every leaf
// once and writes as many into the resident leaves; no arithmetic to speak
// of. What the design does:
//   - one block per (dirty row, leaf), grid (m, L): no block waits on
//     another and no two blocks write the same bytes unless pos repeats
//     (a repeated index carries identical rows, so either writer wins);
//   - the block's threads copy the row 16 bytes at a time when the row
//     size and both addresses are multiples of 16, else 4, else 1;
//   - at the churn audit's shapes (m = 500 rows of 16..64 bytes) the copy
//     is tiny and the launch, not the bytes, sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;

struct LeafDesc {
  unsigned long long dst;        // device address of dst_l's row 0
  unsigned long long src_off;    // byte offset of rows_l in the staging
  unsigned long long row_bytes;  // R_l
  unsigned long long n_rows;     // dst_l's leading dimension (unused here;
                                 // the wrapper checks pos against it)
};

__global__ void rows_update_kernel(const unsigned char* __restrict__ staged,
                                   unsigned long long pos_off) {
  const int i = blockIdx.x;
  const LeafDesc d = reinterpret_cast<const LeafDesc*>(staged)[blockIdx.y];
  const int p = reinterpret_cast<const int32_t*>(staged + pos_off)[i];
  const size_t R = static_cast<size_t>(d.row_bytes);
  const unsigned char* src = staged + d.src_off + static_cast<size_t>(i) * R;
  unsigned char* dst = reinterpret_cast<unsigned char*>(d.dst) +
                       static_cast<size_t>(p) * R;
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) |
                          reinterpret_cast<uintptr_t>(dst) | R;
  if ((align & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* o = reinterpret_cast<uint4*>(dst);
    for (size_t k = threadIdx.x; k < R / 16; k += blockDim.x) o[k] = s[k];
  } else if ((align & 3) == 0) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    uint32_t* o = reinterpret_cast<uint32_t*>(dst);
    for (size_t k = threadIdx.x; k < R / 4; k += blockDim.x) o[k] = s[k];
  } else {
    for (size_t k = threadIdx.x; k < R; k += blockDim.x) dst[k] = src[k];
  }
}

}  // namespace

extern "C" int rows_update(const void* staged, int L, int m,
                           unsigned long long pos_off, void* stream) {
  if (L == 0 || m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rows_update_kernel<<<dim3(m, L), kThreads, 0, s>>>(
      static_cast<const unsigned char*>(staged), pos_off);
  return static_cast<int>(cudaGetLastError());
}
