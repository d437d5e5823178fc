// K3: regex DFA scan over the vocab's byte matrix on Hopper (sm_90a).
//
// Replaces the JAX package's scan_device (gatekeeper_tpu/ops/regex_nfa.py,
// its jitted `run`: a lax.scan over L byte steps with one flat gather into
// the stacked DFA tables per step). P DFAs, padded to S states each, run
// against V strings:
//   table[P, S, 256] int32 next-state ids, accept_end[P, S] uint8,
//   start[P] int32, matched_id[P] int32 (the absorbing match sink),
//   bytes[V, L] uint8, NUL-padded, L a multiple of 16 (16..128);
//   out[P, V] uint8 = final state == matched_id[p] or accept_end[p, state].
// Strings are NUL-free (the host blanks or vetoes any that are not), so the
// first 0 byte is the end of the string: the JAX program freezes the state
// there, and this kernel stops there, which gives the same final state.
//
// Bound: neither bytes nor arithmetic but the dependent chain. Each
// (pattern, string) is a sequential walk, one table load per byte whose
// address depends on the previous load; the bytes moved (V*L + P*V, plus
// the tables once) and the operations are small. What the design does:
//   - one thread per (pattern p, string v): grid (ceil(V / 256), P), so
//     P*V independent chains are in flight to hide the load latency;
//   - each thread reads its string 16 bytes at a time (one uint4 load)
//     instead of one byte per step;
//   - it stops at the NUL pad and at the match sink (its table row is all
//     zeros, so once there the state never leaves): short strings in a
//     long L bucket and early matches cost only the bytes they need;
//   - the tables are read through global memory; a pattern's table is
//     S * 1 KB and stays in L1/L2 across the block. Staging it in shared
//     memory where it fits is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void regex_scan_kernel(const int32_t* __restrict__ table,
                                  const uint8_t* __restrict__ accept_end,
                                  const int32_t* __restrict__ start,
                                  const int32_t* __restrict__ matched_id,
                                  const uint8_t* __restrict__ bytes, int S,
                                  int V, int L, uint8_t* __restrict__ out) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  int p = blockIdx.y;
  if (v >= V) return;
  const int32_t* tab = table + (size_t)p * S * 256;
  const int sink = matched_id[p];
  int state = start[p];
  const uint4* row = reinterpret_cast<const uint4*>(bytes + (size_t)v * L);
  bool done = state == sink;
  for (int c = 0; c < L / 16 && !done; ++c) {
    uint4 chunk = row[c];
    uint32_t w[4] = {chunk.x, chunk.y, chunk.z, chunk.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      // little-endian: byte k of the chunk is byte (k & 3) of word k / 4
      uint32_t b = (w[k >> 2] >> (8 * (k & 3))) & 0xffu;
      if (b == 0u) {
        done = true;
        break;
      }
      state = tab[state * 256 + (int)b];
      if (state == sink) {
        done = true;
        break;
      }
    }
  }
  out[(size_t)p * V + v] =
      (state == sink || accept_end[(size_t)p * S + state]) ? 1 : 0;
}

}  // namespace

extern "C" int regex_scan(const void* table, const void* accept_end,
                          const void* start, const void* matched_id,
                          const void* bytes, int P, int S, int V, int L,
                          void* out, void* stream) {
  if (P == 0 || V == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((V + kThreads - 1) / kThreads, P);
  regex_scan_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(table),
      static_cast<const uint8_t*>(accept_end),
      static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(matched_id),
      static_cast<const uint8_t*>(bytes), S, V, L,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
