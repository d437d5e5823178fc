// K4: inventory-join membership on Hopper (sm_90a).
//
// Replaces the JAX package's join membership program
// (gatekeeper_tpu/ir/join.py, JoinCompiled._jit_wrapper's `run`, fed by
// _fires_device). Inputs, int32 throughout:
//   u_p[Kb]       sorted unique join-key ids, padded with INT32_MAX; Kb a
//                 power of two;
//   cnt_p[Kb]     inventory objects holding each key (0 in the padding);
//   sik_p[G, Kb]  per identity group, the single holder's identity id, or
//                 IK_MULTI when the key has several holders or is padding;
//   karr[N, H]    each review's key ids, padded with key_pad;
//   iks[N, G]     each review's identity id per group;
//   fences[nf]    u_p[0], u_p[S], u_p[2S], ...: the first key of each
//                 segment of S = Kb / nf keys (kernels/join_member.py
//                 `join_fences`: S = LINE, 4 to 32 keys, or S = 1 when
//                 Kb <= LINE, or more past MAX_FENCES fences).
// Output fires[N] uint8: some key of review n is held by another object,
// i.e. u_p[pos] == key != key_pad, where pos is the LEFT insertion point of
// key in u_p clipped to Kb - 1, and either cnt_p[pos] >= 2 or no group g
// has sik_p[g, pos] == iks[n, g]. The sentinels (IK_*, KEY_PAD, the
// INT32_MAX padding) never equal a real id or each other.
//
// Bound: bytes, in the limit, and latency in practice. The function reads
// karr and iks once and writes one byte per review; a plain binary search
// makes log2(Kb) dependent loads per key into u_p (15 L2 round trips at
// the audit's Kb of 32,768). What the design does:
//   - a two-level search with the same result: each block stages the
//     fences in shared memory (16-byte loads; 8 KB at Kb = 32,768 and
//     LINE 16); a key takes a branchless lower_bound over them there
//     (log2(nf) + 1 steps of shared-memory latency), which names the one
//     segment that holds its insertion point; the segment's line of
//     LINE keys is read as LINE / 4 independent 16-byte loads (halving
//     first while a segment is longer than 32 keys) and the keys below
//     the key counted: one round trip to memory where there were 15;
//   - one thread per review row n, grid-stride, at most 8 blocks of 256
//     threads an SM, looping over its H keys and skipping key_pad; then
//     the clip, the equality test, the count and the G identity
//     compares, stopping at the first key that fires; the first row's
//     first key and identity are loaded while the fences stage, and the
//     count with the identities, so that a key costs three dependent
//     round trips to memory (key, line, count and identities);
//   - every output byte has one writer, so the result is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2,048 threads: a full SM

// The left insertion point of `key` in u_p, unclipped, in [0, Kb], and
// whether u_p holds `key` there; the search ends in a line of kLine keys.
template <int kLine>
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ u_p,
                                           const int32_t* s_f, int nf,
                                           int seg, int Kb, int32_t key,
                                           bool* found) {
  // j = fences below key: fence j - 1 < key <= fence j, so the insertion
  // point lies in segment j - 1 past its first key, or is j * seg
  int b = 0;
  for (int half = nf >> 1; half > 0; half >>= 1)
    b = s_f[b + half - 1] < key ? b + half : b;
  const int j = b + (s_f[b] < key);
  if (j == 0) {
    *found = s_f[0] == key;
    return 0;
  }
  if (seg == 1) {  // the fences are u_p itself
    *found = j < nf && s_f[j] == key;
    return j;
  }
  // u_p[base] < key and u_p[base + len] >= key (or base + len == Kb)
  int base = (j - 1) * seg;
  for (int len = seg; len > kLine;) {
    len >>= 1;
    base = __ldg(u_p + base + len) < key ? base + len : base;
  }
  const int4* line = reinterpret_cast<const int4*>(u_p + base);
  int4 v[kLine / 4];
#pragma unroll
  for (int t = 0; t < kLine / 4; ++t) v[t] = __ldg(line + t);
  int below = 0;
  bool eq = false;
#pragma unroll
  for (int t = 0; t < kLine / 4; ++t) {
    below += (v[t].x < key) + (v[t].y < key) + (v[t].z < key) +
             (v[t].w < key);
    eq |= (v[t].x == key) | (v[t].y == key) | (v[t].z == key) |
          (v[t].w == key);
  }
  const int pos = base + below;
  // below == kLine: the point is the next line's first key, if any
  *found = eq || (below == kLine && pos < Kb && __ldg(u_p + pos) == key);
  return pos;
}

// Review n's fire bit; `key` and `ik0` are its first key and its first
// identity id (loaded early by the caller).
template <int kLine>
__device__ __forceinline__ bool review_fires(
    const int32_t* __restrict__ u_p, const int32_t* __restrict__ cnt_p,
    const int32_t* __restrict__ sik_p, const int32_t* __restrict__ karr,
    const int32_t* __restrict__ iks, const int32_t* s_f, int n, int H,
    int Kb, int G, int nf, int seg, int key_pad, int32_t key, int32_t ik0) {
  for (int h = 0; h < H; ++h) {
    if (h > 0) key = karr[(size_t)n * H + h];
    if (key == key_pad) continue;
    bool found;
    int pos = lower_bound<kLine>(u_p, s_f, nf, seg, Kb, key, &found);
    if (!found) continue;
    pos = pos < Kb - 1 ? pos : Kb - 1;
    // the count and the identities, loaded together: one round trip
    const int32_t count = __ldg(cnt_p + pos);
    bool ident = G > 0 && __ldg(sik_p + pos) == ik0;
    for (int g = 1; g < G; ++g)
      ident |= __ldg(sik_p + (size_t)g * Kb + pos) ==
               __ldg(iks + (size_t)n * G + g);
    if (count >= 2 || !ident) return true;
  }
  return false;
}

template <int kLine>
__global__ void join_member_kernel(const int32_t* __restrict__ u_p,
                                   const int32_t* __restrict__ cnt_p,
                                   const int32_t* __restrict__ sik_p,
                                   const int32_t* __restrict__ karr,
                                   const int32_t* __restrict__ iks,
                                   const int32_t* __restrict__ fences,
                                   int N, int H, int Kb, int G, int nf,
                                   int key_pad, uint8_t* __restrict__ fires) {
  extern __shared__ int4 s_raw[];
  int32_t* s_f = reinterpret_cast<int32_t*>(s_raw);
  // the first review's first key and identity id, in flight while the
  // block stages the fences
  const int n0 = blockIdx.x * blockDim.x + threadIdx.x;
  int32_t key = key_pad, ik0 = 0;
  if (n0 < N) {
    if (H > 0) key = karr[(size_t)n0 * H];
    if (G > 0) ik0 = iks[(size_t)n0 * G];
  }
  if (nf >= 4) {
    for (int k = threadIdx.x; k < nf / 4; k += blockDim.x)
      s_raw[k] = reinterpret_cast<const int4*>(fences)[k];
  } else if (threadIdx.x < nf) {
    s_f[threadIdx.x] = fences[threadIdx.x];
  }
  __syncthreads();
  const int seg = Kb / nf;

  for (int n = n0; n < N; n += gridDim.x * blockDim.x) {
    if (n != n0) {
      key = H > 0 ? karr[(size_t)n * H] : key_pad;
      ik0 = G > 0 ? iks[(size_t)n * G] : 0;
    }
    fires[n] = review_fires<kLine>(u_p, cnt_p, sik_p, karr, iks, s_f, n, H,
                                   Kb, G, nf, seg, key_pad, key, ik0);
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

extern "C" int join_member(const void* u_p, const void* cnt_p,
                           const void* sik_p, const void* karr,
                           const void* iks, const void* fences, int N,
                           int H, int Kb, int G, int nf, int key_pad,
                           void* fires, void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = (N + kThreads - 1) / kThreads;
  const int cap = sm_count() * kBlocksPerSm;
  if (cap > 0 && blocks > cap) blocks = cap;
  const size_t smem = ((static_cast<size_t>(nf) * 4 + 15) / 16) * 16;
  // the line the search ends in: the segment, or 32 keys (128 bytes) when
  // segments are longer (seg is 1, when the fences are u_p itself, or a
  // power of two >= 4: kernels/join_member.py LINE)
  const int seg = Kb / nf;
  auto kernel = seg >= 32 ? join_member_kernel<32>
                : seg >= 16 ? join_member_kernel<16>
                : seg >= 8  ? join_member_kernel<8>
                            : join_member_kernel<4>;
  kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const int32_t*>(u_p), static_cast<const int32_t*>(cnt_p),
      static_cast<const int32_t*>(sik_p), static_cast<const int32_t*>(karr),
      static_cast<const int32_t*>(iks), static_cast<const int32_t*>(fences),
      N, H, Kb, G, nf, key_pad, static_cast<uint8_t*>(fires));
  return static_cast<int>(cudaGetLastError());
}
