// B10: row gather, out[i, :] = table[clamp(ids[i], 0, rows - 1), :].
//
// Replaces benchmarks/exp_fused_gather.py::_dma_gather_kernel (the TPU
// per-row DMA gather, 16 row copies in flight per grid step), the gather
// the JAX package leaves to XLA's take (mode="clip") everywhere else. On
// the H100 it is bound by bytes: every output row is one table row read
// and one row written, plus the ids; no arithmetic.
//
// Design: the output is a flat run of vectors, n * (row_bytes / VB) of
// them, where VB is the widest of 16, 8, 4, 2, 1 bytes that divides the
// row and both base addresses. The 32 lanes of a warp take 32 neighbouring
// vectors, so a warp streams a group of output rows: a slice of one wide
// row (a 264-column bf16 row is 33 16-byte vectors), or several narrow
// rows side by side (a [nnz, 8] f32 row is two vectors). Each lane issues
// U read-only loads (ld.global.nc) before its first store, so U vectors
// per lane, 32 * U per warp, are in flight: the CUDA form of the TPU
// kernel's 16 outstanding row DMAs. The grid covers the output in one
// pass, and the stores stream (st.global.cs): the output is not read back
// by this kernel, so it should not displace the table's rows in L2, which
// the gather reads again for every entry of a row's segment. Narrow rows
// (under 16 bytes) take the narrower vectors, down to single bytes, and a
// one-vector row skips the division by the row's length. Any row width
// and element size is served. ids are int32 or int64; an id below 0 reads
// row 0 and one at or past `rows` reads the last row, as
// jnp.take(mode="clip").
//
// Variants timed on the H100 (chip runs: the main path's [451,178, 264]
// bf16 and [406,948, 5,280] f32 gathers): a grid capped at 16 blocks per
// SM and plain stores ran 2-8% slower than this one, a warp per row no
// faster.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename V>
__device__ __forceinline__ V ldg(const V* p) {
  return __ldg(p);
}

template <typename V, typename I, bool ONE>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const V* __restrict__ table, const I* __restrict__ ids, V* __restrict__ out,
                  long long total, long long vecs, long long rows) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long base = (long long)blockIdx.x * kThreads + threadIdx.x; base < total;
       base += stride * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long t = base + u * stride;
      if (t < total) {
        const long long row = ONE ? t : t / vecs;
        long long src = (long long)ids[row];
        src = src < 0 ? 0 : (src >= rows ? rows - 1 : src);
        v[u] = ldg(table + (ONE ? src : src * vecs + (t - row * vecs)));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long t = base + u * stride;
      if (t < total) __stcs(out + t, v[u]);
    }
  }
}

template <typename V, typename I, bool ONE>
void launch_ids(const void* table, const void* ids, void* out, long long total, long long vecs,
                long long rows, cudaStream_t s) {
  long long blocks = (total + (long long)kThreads * kUnroll - 1) / ((long long)kThreads * kUnroll);
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;  // the grid strides past that
  gather_kernel<V, I, ONE><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const V*>(table), static_cast<const I*>(ids), static_cast<V*>(out), total, vecs,
      rows);
}

template <typename V>
int launch(const void* table, const void* ids, int ids64, void* out, long long n,
           long long rows, long long row_bytes, cudaStream_t s) {
  const long long vecs = row_bytes / (long long)sizeof(V);
  const long long total = n * vecs;
  if (ids64 && vecs == 1) launch_ids<V, long long, true>(table, ids, out, total, vecs, rows, s);
  else if (ids64) launch_ids<V, long long, false>(table, ids, out, total, vecs, rows, s);
  else if (vecs == 1) launch_ids<V, int, true>(table, ids, out, total, vecs, rows, s);
  else launch_ids<V, int, false>(table, ids, out, total, vecs, rows, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table [rows, row_bytes] bytes, ids [n] int32 (ids64 = 0) or int64, out
// [n, row_bytes]. Returns cudaGetLastError() after the launch.
int allset_gather(const void* table, const void* ids, int ids64, void* out, long long n,
                  long long rows, long long row_bytes, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n <= 0 || row_bytes <= 0) return (int)cudaGetLastError();
  if (rows <= 0) return (int)cudaErrorInvalidValue;
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
