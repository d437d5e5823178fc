// K3: regex DFA scan over the packed vocab on Hopper (sm_90a).
//
// Replaces the JAX package's scan_device (gatekeeper_tpu/ops/regex_nfa.py,
// its jitted `run`: a lax.scan over L byte steps with one flat gather into
// the stacked DFA tables per step). P DFAs run against V strings:
//   buf uint8, the strings back to back, zero-padded to 16 bytes;
//   offsets[V+1] int32, string v = buf[offsets[v] .. offsets[v+1]),
//     each at most kMaxLen bytes;
//   blob uint8, per pattern (16-byte aligned): cls[256] byte -> class,
//     nxt[S][n_cls] uint16 next states, acc[S] uint8 accept_end;
//   pdesc[P][6] int32 (part offset in its group, n_cls, S, start, sink,
//     dead or -1); gdesc[G][4] int32 (first pattern, patterns, blob
//     offset, bytes) for groups of consecutive patterns;
//   out[P, V] uint8 = final state == sink or acc[final state].
// The JAX program freezes a string's state past its end; this kernel
// stops there, and also at the sink and the dead state, which absorb
// every byte, so the final state is the same.
//
// Bound: the dependent chain. A walk is one load a byte whose address
// depends on the previous load's result; the bytes the data needs (the
// strings up to their longest walk, the tables once, the output) move in
// well under a microsecond at the main path's 2 x 149,999 strings, so the
// launch and the longest chains set the time. What the design does:
//   - the chain's load comes from shared memory: a block stages its
//     group's compressed tables (uint16 states over a few byte classes,
//     not int32 over 256 bytes), so one step is a class lookup that does
//     not depend on the state, and one shared-memory load that does; the
//     bytes and classes of 4 steps load ahead of their 4 dependent loads;
//   - one thread per string walks every pattern of its group, two walks
//     interleaved, so two independent chains hide each other's latency
//     and each string is read once per group, not once per pattern; with
//     few strings the host cuts groups smaller (MIN_BLOCKS_PER_SM), so
//     that a thread's patterns do not queue one after another on an idle
//     card;
//   - a block reads its 256 strings' byte span once, with coalesced
//     aligned 16-byte loads, into shared memory; strings are at most
//     kMaxLen bytes (scan_device checks it on the host), so the span
//     always fits kSpanCap, and a block whose span does not traps;
//   - walks stop at the string's end, the sink or the dead state: most
//     strings leave an anchored pattern's start on their first byte;
//   - one launch for all groups (grid y), and out is written coalesced
//     along V. A group over the wrapper's table_smem (a pattern whose
//     tables alone exceed GROUP_TABLE_BYTES) reads its tables from global
//     memory through L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLen = 128;
constexpr int kSpanCap = kThreads * kMaxLen + 32;
constexpr int kPdesc = 6;
constexpr int kMaxTableSmem = 8192;  // GROUP_TABLE_BYTES

struct Walk {
  const uint8_t* cls;
  const uint16_t* nxt;
  const uint8_t* acc;
  int n_cls, state, sink, dead;
  bool live;
};

__device__ __forceinline__ Walk open_walk(const uint8_t* tabs,
                                          const int32_t* pd, int n) {
  Walk w;
  const uint8_t* part = tabs + pd[0];
  w.n_cls = pd[1];
  w.cls = part;
  w.nxt = reinterpret_cast<const uint16_t*>(part + 256);
  w.acc = part + 256 + 2 * pd[2] * pd[1];
  w.state = pd[3];
  w.sink = pd[4];
  w.dead = pd[5];
  w.live = n > 0 && w.state != w.sink && w.state != w.dead;
  return w;
}

// one byte of class k: the only load that waits on the previous one
__device__ __forceinline__ void step(Walk& w, uint32_t k) {
  if (w.live) {
    w.state = w.nxt[w.state * w.n_cls + k];
    w.live = w.state != w.sink && w.state != w.dead;
  }
}

__device__ __forceinline__ uint8_t verdict(const Walk& w) {
  return (w.state == w.sink || w.acc[w.state]) ? 1 : 0;
}

// every pattern of the group against the string s[0, n), two at a time,
// kStep bytes a round: the bytes and their classes do not depend on the
// walks' states, so they load before the round's dependent steps
constexpr int kStep = 4;

__device__ __forceinline__ void walk_group(const uint8_t* s, int n,
                                           const uint8_t* tabs,
                                           const int32_t* pdesc, int p0,
                                           int np, int V, int v,
                                           uint8_t* out) {
  for (int k = 0; k < np; k += 2) {
    const int p = p0 + k;
    const bool two = k + 1 < np;
    Walk a = open_walk(tabs, pdesc + kPdesc * p, n);
    Walk b = open_walk(tabs, pdesc + kPdesc * (two ? p + 1 : p), two ? n : 0);
    for (int i = 0; i < n && (a.live || b.live); i += kStep) {
      uint32_t ka[kStep], kb[kStep];
#pragma unroll
      for (int j = 0; j < kStep; ++j) {
        const uint32_t c = i + j < n ? s[i + j] : 0u;
        ka[j] = a.cls[c];
        kb[j] = b.cls[c];
      }
#pragma unroll
      for (int j = 0; j < kStep; ++j) {
        if (i + j < n) {
          step(a, ka[j]);
          step(b, kb[j]);
        }
      }
    }
    out[(size_t)p * V + v] = verdict(a);
    if (two) out[(size_t)(p + 1) * V + v] = verdict(b);
  }
}

__global__ void __launch_bounds__(kThreads) regex_scan_kernel(
    const uint8_t* __restrict__ buf, const int32_t* __restrict__ offsets,
    int V, const uint8_t* __restrict__ blob,
    const int32_t* __restrict__ pdesc, const int32_t* __restrict__ gdesc,
    int table_smem, uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  const int32_t* gd = gdesc + 4 * blockIdx.y;
  const int p0 = gd[0], np = gd[1], toff = gd[2], tlen = gd[3];
  const bool tabs_staged = tlen <= table_smem;
  const int v0 = blockIdx.x * kThreads;
  const int v1 = min(v0 + kThreads, V);
  const int base = offsets[v0] & ~15;
  const int span = ((offsets[v1] + 15) & ~15) - base;
  if (span > kSpanCap) __trap();  // a string over kMaxLen bytes
  uint4* stabs = smem;
  uint4* sspan = smem + table_smem / 16;
  if (tabs_staged) {
    const uint4* src = reinterpret_cast<const uint4*>(blob + toff);
    for (int i = threadIdx.x; i < tlen / 16; i += kThreads) stabs[i] = src[i];
  }
  {
    const uint4* src = reinterpret_cast<const uint4*>(buf + base);
    for (int i = threadIdx.x; i < span / 16; i += kThreads) sspan[i] = src[i];
  }
  __syncthreads();
  const int v = v0 + threadIdx.x;
  if (v >= V) return;
  const int b = offsets[v];
  const int n = offsets[v + 1] - b;
  const uint8_t* s = reinterpret_cast<const uint8_t*>(sspan) + (b - base);
  if (tabs_staged) {
    walk_group(s, n, reinterpret_cast<const uint8_t*>(stabs), pdesc, p0, np,
               V, v, out);
  } else {
    walk_group(s, n, blob + toff, pdesc, p0, np, V, v, out);
  }
}

}  // namespace

extern "C" int regex_scan(const void* buf, const void* offsets, int V,
                          const void* blob, const void* pdesc,
                          const void* gdesc, int P, int G, int table_smem,
                          void* out, void* stream) {
  if (P == 0 || V == 0 || G == 0) return 0;
  if (table_smem < 0 || table_smem > kMaxTableSmem || table_smem % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // at most 40,992 bytes: under the 48 KB a launch may take unasked
  const int smem = table_smem + kSpanCap;
  dim3 grid((V + kThreads - 1) / kThreads, G);
  regex_scan_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const uint8_t*>(buf), static_cast<const int32_t*>(offsets),
      V, static_cast<const uint8_t*>(blob),
      static_cast<const int32_t*>(pdesc), static_cast<const int32_t*>(gdesc),
      table_smem, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
