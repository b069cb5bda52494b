// B9: row gather by sorted ids, out[i, :] = table[clamp(ids[i], 0, rows - 1), :],
// each run of equal ids reading its row once.
//
// Replaces benchmarks/exp_fused_gather.py::_vmem_gather_kernel (the TPU
// gather from a table held whole in VMEM). No SM holds a whole table (a
// 131,072 x 8 f32 score table is 4 MiB, an SM's shared memory 228 KB), so
// what is held on chip here is a run's row, in the registers of the lanes
// that write it. On the H100 it is bound by bytes (each distinct row read
// once, each output row written once, plus the ids) and, at the model's
// sizes (0.3 to 5 M ids of 4 to 32 B), by the latency of the chain ids ->
// rows -> stores: so the design has no block barrier, no shared memory and
// many warps in flight.
//
// Where it is used: a gather by sorted ids (the destination ids of a
// graph's entries, one run per destination) of a narrow row, the [rows, H]
// score tables of an attention softmax (ops/segment.py routes by the row's
// bytes). B10 (csrc/gather.cu) fetches the row again for every entry of a
// run; this kernel fetches it once per run and warp.
//
// Design: a row is nv vectors of vb bytes, vb the widest of 16, 8, 4, 2, 1
// that divides the row and both base addresses. L lanes take a row (the
// least power of two >= nv, at most 32), so a warp step covers P = 32 / L
// consecutive ids, lane (q, c) = (lane / L, lane % L) vector c of the q-th.
// A warp takes a span of S steps (SP consecutive ids), S the fewest of 2,
// 4 and 8 that keep the grid within one wave of 24 warps per SM (kWave
// warps: about what the 8-step kernels' 64-103 registers let an SM
// hold), so that a small gather still spreads over the SMs and a
// large one keeps 8 steps of loads in flight a warp: at CEGAT's 280,576
// ids 4 steps for one-vector rows and 8 for two-vector rows, 8 from
// 405,505 ids of one vector (202,753 of two). It loads and clamps all the
// span's ids first and marks the run heads (an id whose row differs from
// the id before it, through __shfl_up_sync; the span's first id is a
// head), then issues every head's row loads, all S steps' in flight, then
// hands each row to its run's other ids with __shfl_sync: the nearest head
// slot at or before the id in its step, from a __ballot_sync of the step's
// heads, or, where the run began in an earlier step, that step's last slot
// (the carry). The output vectors go out as coalesced streaming stores
// (the output is not read back here). Rows of more than 32 vectors are
// done in column chunks of 32 vectors. Only the sharing depends on the
// order of the ids: unsorted ids make more heads and read more rows, and
// the result is exact for any ids, as B10's is.
// ids are int32 or int64; an id below 0 reads row 0 and one at or past
// `rows` reads the last row, as jnp.take(mode="clip").

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kWave = 132 * 24;  // warps of one wave: 24 per SM of the H100's 132
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint4 shfl(uint4 v, int src) {
  v.x = __shfl_sync(kFull, v.x, src);
  v.y = __shfl_sync(kFull, v.y, src);
  v.z = __shfl_sync(kFull, v.z, src);
  v.w = __shfl_sync(kFull, v.w, src);
  return v;
}
__device__ __forceinline__ uint2 shfl(uint2 v, int src) {
  v.x = __shfl_sync(kFull, v.x, src);
  v.y = __shfl_sync(kFull, v.y, src);
  return v;
}
__device__ __forceinline__ unsigned int shfl(unsigned int v, int src) {
  return __shfl_sync(kFull, v, src);
}
__device__ __forceinline__ unsigned short shfl(unsigned short v, int src) {
  return (unsigned short)__shfl_sync(kFull, (unsigned int)v, src);
}
__device__ __forceinline__ unsigned char shfl(unsigned char v, int src) {
  return (unsigned char)__shfl_sync(kFull, (unsigned int)v, src);
}

template <typename V, typename I, int S>
__global__ void __launch_bounds__(kThreads)
    gather_sorted_kernel(const V* __restrict__ table, const I* __restrict__ ids,
                         V* __restrict__ out, long long n, int rows, int nv, int lg) {
  const int lane = threadIdx.x & 31;
  const int L = 1 << lg, P = 32 >> lg;
  const int q = lane >> lg, cl = lane & (L - 1);
  const int last = (P - 1) * L + cl;          // the step's last slot, this column
  const unsigned upto = (2u << (q * L)) - 1u;  // lanes 0 .. q * L (all, at 31)
  const long long span = (long long)S * P;
  const long long stride = (long long)gridDim.x * kWarps * span;
  for (long long base = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * span; base < n;
       base += stride) {
    int row[S];  // clamped; -1 past n
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const long long j = base + u * P + q;
      row[u] = -1;
      if (j < n) {
        const long long r = (long long)__ldcs(ids + j);
        row[u] = (int)(r < 0 ? 0 : (r >= rows ? rows - 1 : r));
      }
    }
    bool head[S];
#pragma unroll
    for (int u = 0; u < S; ++u) {
      int prev = __shfl_up_sync(kFull, row[u], L);
      const int before = u > 0 ? __shfl_sync(kFull, row[u - 1], last) : -1;
      if (q == 0) prev = before;
      head[u] = row[u] >= 0 && row[u] != prev;
    }
    for (int c0 = 0; c0 < nv; c0 += L) {
      const int c = c0 + cl;
      const bool on = c < nv;
      V v[S] = {};
#pragma unroll
      for (int u = 0; u < S; ++u)
        if (head[u] && on) v[u] = __ldg(table + (long long)row[u] * nv + c);
      V carry = {};
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const unsigned heads = __ballot_sync(kFull, head[u] && cl == 0) & upto;
        const V w = shfl(v[u], heads ? (31 - __clz(heads)) + cl : lane);
        v[u] = heads ? w : carry;
        carry = shfl(v[u], last);
      }
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const long long j = base + u * P + q;
        if (j < n && on) __stcs(out + j * nv + c, v[u]);
      }
    }
  }
}

template <typename V, typename I, int S>
void launch_span(const V* table, const I* ids, V* out, long long n, int rows, int nv, int lg,
                 cudaStream_t s) {
  const long long span = (long long)S * (32 >> lg);
  long long blocks = ((n + span - 1) / span + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;  // the grid strides past that
  gather_sorted_kernel<V, I, S><<<(unsigned)blocks, kThreads, 0, s>>>(table, ids, out, n, rows,
                                                                      nv, lg);
}

template <typename V, typename I>
void launch_ids(const void* table, const void* ids, void* out, long long n, long long rows,
                int nv, int lg, cudaStream_t s) {
  const long long warp_steps = (n + (32 >> lg) - 1) / (32 >> lg);
  const V* t = static_cast<const V*>(table);
  const I* i = static_cast<const I*>(ids);
  V* o = static_cast<V*>(out);
  if (warp_steps <= 2 * kWave) launch_span<V, I, 2>(t, i, o, n, (int)rows, nv, lg, s);
  else if (warp_steps <= 4 * kWave) launch_span<V, I, 4>(t, i, o, n, (int)rows, nv, lg, s);
  else launch_span<V, I, 8>(t, i, o, n, (int)rows, nv, lg, s);
}

template <typename V>
int launch(const void* table, const void* ids, int ids64, void* out, long long n, long long rows,
           long long row_bytes, cudaStream_t s) {
  const int nv = (int)(row_bytes / (long long)sizeof(V));
  int lg = 0;
  while (lg < 5 && (1 << lg) < nv) ++lg;
  if (ids64) launch_ids<V, long long>(table, ids, out, n, rows, nv, lg, s);
  else launch_ids<V, int>(table, ids, out, n, rows, nv, lg, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table [rows, row_bytes] bytes, ids [n] int32 (ids64 = 0) or int64, out
// [n, row_bytes]; rows below 2^31, rows of fewer than 2^31 vectors.
// Returns cudaGetLastError() after the launch.
int allset_gather_sorted(const void* table, const void* ids, int ids64, void* out, long long n,
                         long long rows, long long row_bytes, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n <= 0 || row_bytes <= 0) return (int)cudaGetLastError();
  if (rows <= 0 || rows > 0x7fffffffLL || row_bytes > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out) |
                          (uintptr_t)row_bytes;
  if (align % 16 == 0) return launch<uint4>(table, ids, ids64, out, n, rows, row_bytes, s);
  if (align % 8 == 0) return launch<uint2>(table, ids, ids64, out, n, rows, row_bytes, s);
  if (align % 4 == 0) return launch<unsigned int>(table, ids, ids64, out, n, rows, row_bytes, s);
  if (align % 2 == 0)
    return launch<unsigned short>(table, ids, ids64, out, n, rows, row_bytes, s);
  return launch<unsigned char>(table, ids, ids64, out, n, rows, row_bytes, s);
}

}  // extern "C"
