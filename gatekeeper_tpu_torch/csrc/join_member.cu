// K4: inventory-join membership on Hopper (sm_90a).
//
// Replaces the JAX package's join membership program
// (gatekeeper_tpu/ir/join.py, JoinCompiled._jit_wrapper's `run`, fed by
// _fires_device). Inputs, int32 throughout:
//   u_p[Kb]       sorted unique join-key ids, padded with INT32_MAX;
//   cnt_p[Kb]     inventory objects holding each key (0 in the padding);
//   sik_p[G, Kb]  per identity group, the single holder's identity id, or
//                 IK_MULTI when the key has several holders or is padding;
//   karr[N, H]    each review's key ids, padded with key_pad;
//   iks[N, G]     each review's identity id per group.
// Output fires[N] uint8: some key of review n is held by another object,
// i.e. u_p[pos] == key != key_pad, where pos is the LEFT insertion point of
// key in u_p clipped to Kb - 1, and either cnt_p[pos] >= 2 or no group g
// has sik_p[g, pos] == iks[n, g]. The sentinels (IK_*, KEY_PAD, the
// INT32_MAX padding) never equal a real id or each other.
//
// Bound: bytes, in the limit, and latency in practice. The function reads
// karr and iks once and writes one byte per review; the binary search makes
// log2(Kb) dependent loads per key into u_p, which at the audit's Kb
// (32,768 int32, 128 KB) stays in L2. What the design does:
//   - one thread per review row n, looping over its H keys and skipping
//     key_pad: no cross-thread work, no atomics;
//   - a branchy lower_bound per key (exactly jnp.searchsorted's left side),
//     then the clip, the equality test, the count and the G identity
//     compares, stopping at the first key that fires;
//   - every output byte has one writer, so the result is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void join_member_kernel(const int32_t* __restrict__ u_p,
                                   const int32_t* __restrict__ cnt_p,
                                   const int32_t* __restrict__ sik_p,
                                   const int32_t* __restrict__ karr,
                                   const int32_t* __restrict__ iks, int N,
                                   int H, int Kb, int G, int key_pad,
                                   uint8_t* __restrict__ fires) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  bool fire = false;
  for (int h = 0; h < H && !fire; ++h) {
    int key = karr[(size_t)n * H + h];
    if (key == key_pad) continue;
    int lo = 0, hi = Kb;
    while (lo < hi) {
      int mid = lo + ((hi - lo) >> 1);
      if (u_p[mid] < key) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int pos = lo < Kb - 1 ? lo : Kb - 1;
    if (u_p[pos] != key) continue;
    if (cnt_p[pos] >= 2) {
      fire = true;
      break;
    }
    bool ident = false;
    for (int g = 0; g < G; ++g) {
      if (sik_p[(size_t)g * Kb + pos] == iks[(size_t)n * G + g]) {
        ident = true;
        break;
      }
    }
    fire = !ident;
  }
  fires[n] = fire ? 1 : 0;
}

}  // namespace

extern "C" int join_member(const void* u_p, const void* cnt_p,
                           const void* sik_p, const void* karr,
                           const void* iks, int N, int H, int Kb, int G,
                           int key_pad, void* fires, void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  join_member_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const int32_t*>(u_p), static_cast<const int32_t*>(cnt_p),
      static_cast<const int32_t*>(sik_p), static_cast<const int32_t*>(karr),
      static_cast<const int32_t*>(iks), N, H, Kb, G, key_pad,
      static_cast<uint8_t*>(fires));
  return static_cast<int>(cudaGetLastError());
}
