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
// The copy is cut into UNITS. Leaf l has a unit width w_l (the widest of
// 16/8/4/2/1 bytes dividing both its row size R_l and its base address),
// c_l = R_l / w_l units a row and m c_l units in all; the units of all
// leaves are numbered leaf after leaf, row after row, in the order of the
// staged bytes, so unit u of leaf l reads staged bytes
// [src_l + (u - prefix_l) w_l, + w_l).
//
// Everything the kernel reads arrives in ONE staged device buffer, copied
// from one pinned host buffer by the wrapper (kernels/rows_update.py
// `pack`):
//   [0, 4 (L + 1))          prefix[L + 1] uint32: units of the leaves
//                           before l (prefix[L] = U, all units);
//   [desc_off, +24 L)       L LeafDesc, desc_off = 4 (L + 1) rounded up
//                           to 8; the table ends at table_bytes, a
//                           multiple of 16;
//   [pos_off, +4 m)         pos[m] int32, pos_off = table_bytes;
//   [src_l, +m R_l)         leaf l's m rows back to back, src_l a
//                           multiple of 16.
//
// Bound: bytes. The function reads the m R_l staged bytes of every leaf
// once and writes as many into the resident leaves. At the churn audit's
// shapes (84 leaves of 1..8-byte rows, m = 500) that is about 400 KB, far
// below a launch's cost, so the design is about scheduling:
//   - one flat 1-D launch over the U units, grid-stride, at most 8 blocks
//     of 256 threads an SM: consecutive threads copy consecutive staged
//     units (coalesced reads), and one wave covers the churn audit's
//     42,000 units, where a grid of (row, leaf) blocks of 1..4 busy
//     threads each took 42,000 blocks;
//   - each block copies the descriptor table into shared memory once;
//     a thread finds its leaf by a branchless search over the prefix
//     there, then its row and chunk by one division, and copies w_l bytes
//     with one load and one store of that width;
//   - no two threads write the same bytes unless pos repeats (a repeated
//     index carries identical rows, so either writer wins).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2,048 threads: a full SM

struct LeafDesc {
  unsigned long long dst;  // device address of dst_l's row 0
  unsigned long long src;  // byte offset of rows_l in the staging
  uint32_t w;              // unit width w_l: 16, 8, 4, 2 or 1 bytes
  uint32_t c;              // units a row, R_l / w_l
};
static_assert(sizeof(LeafDesc) == 24, "kernels/rows_update.py _DESC");

__global__ void rows_update_kernel(const unsigned char* __restrict__ staged,
                                   int L, unsigned int table_bytes,
                                   unsigned int desc_off,
                                   unsigned long long pos_off,
                                   unsigned int U) {
  extern __shared__ uint4 s_table[];
  const uint4* table = reinterpret_cast<const uint4*>(staged);
  for (unsigned int k = threadIdx.x; k < table_bytes / 16; k += blockDim.x)
    s_table[k] = table[k];
  __syncthreads();
  const uint32_t* prefix = reinterpret_cast<const uint32_t*>(s_table);
  const LeafDesc* desc = reinterpret_cast<const LeafDesc*>(
      reinterpret_cast<const unsigned char*>(s_table) + desc_off);
  const int32_t* pos = reinterpret_cast<const int32_t*>(staged + pos_off);

  for (unsigned int u = blockIdx.x * blockDim.x + threadIdx.x; u < U;
       u += gridDim.x * blockDim.x) {
    // the last leaf l with prefix[l] <= u (prefix[0] = 0): it has units,
    // since prefix[l + 1] > u
    int l = 0;
    for (int len = L; len > 1;) {
      const int half = len >> 1;
      l = prefix[l + half] <= u ? l + half : l;
      len -= half;
    }
    const LeafDesc d = desc[l];
    const uint32_t local = u - prefix[l];
    const uint32_t i = local / d.c;
    const uint32_t k = local - i * d.c;
    const unsigned char* src =
        staged + d.src + static_cast<size_t>(local) * d.w;
    unsigned char* dst = reinterpret_cast<unsigned char*>(d.dst) +
        (static_cast<size_t>(pos[i]) * d.c + k) * d.w;
    switch (d.w) {
      case 16:
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        break;
      case 8:
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
        break;
      case 4:
        *reinterpret_cast<uint32_t*>(dst) =
            *reinterpret_cast<const uint32_t*>(src);
        break;
      case 2:
        *reinterpret_cast<uint16_t*>(dst) =
            *reinterpret_cast<const uint16_t*>(src);
        break;
      default:
        *dst = *src;
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace

extern "C" int rows_update(const void* staged, int L,
                           unsigned int table_bytes, unsigned int desc_off,
                           unsigned long long pos_off, unsigned int U,
                           void* stream) {
  if (L == 0 || U == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int blocks = (U + kThreads - 1) / kThreads;
  const unsigned int cap =
      static_cast<unsigned int>(sm_count()) * kBlocksPerSm;
  if (cap > 0 && blocks > cap) blocks = cap;
  rows_update_kernel<<<blocks, kThreads, table_bytes, s>>>(
      static_cast<const unsigned char*>(staged), L, table_bytes, desc_off,
      pos_off, U);
  return static_cast<int>(cudaGetLastError());
}
