// B9: row gather through shared memory, out[i, :] = table[clamp(ids[i], 0, rows - 1), :],
// for ids that come in runs of equal values (sorted ids).
//
// Replaces benchmarks/exp_fused_gather.py::_vmem_gather_kernel (the TPU
// gather from a table held whole in VMEM). No SM holds a whole table (a
// 131,072 x 8 f32 score table is 4 MiB, an SM's shared memory 228 KB), so
// what is held on chip here is the part of the table a block needs: the
// rows of its chunk's ids. On the H100 it is bound by bytes: each distinct
// row of a chunk read once, each output row written once, plus the ids.
//
// Where it is used: a gather by sorted ids (the destination ids of a
// graph's entries, one run per destination) of a narrow row, the [rows, H]
// score tables of an attention softmax (ops/segment.py routes by the row's
// bytes). B10 (csrc/gather.cu) fetches the row again for every entry of a
// run; this kernel fetches it once per run and chunk.
//
// Design: a block of 256 threads takes a chunk of 1,024 consecutive ids,
// four per thread. Each thread clamps its ids and marks the run heads among
// them (an id unlike the one before it; the chunk's first id is a head); a
// block scan of the head counts numbers the runs, and each head writes its
// row and its first position into shared memory, each id its run. The
// rows of the runs are then copied into a 32 KB staging buffer in shared
// memory, one vector per thread at a time over the flattened rows
// (cp.async of 4, 8 or 16 bytes, all in flight before one wait), and every
// output row of the chunk is written from there, the threads on
// neighbouring output vectors (coalesced, streaming stores: the output is
// not read back here). A chunk whose runs need more than 32 KB (unsorted
// ids, or wide rows) is done in passes of as many runs as fit, inside the
// block. Only the sharing depends on the order of the ids, so the result is
// exact for any ids, as B10's is. Vectors are the widest of 16, 8, 4, 2, 1
// bytes that divide the row and both base addresses. ids are int32 or
// int64; an id below 0 reads row 0 and one at or past `rows` reads the last
// row, as jnp.take(mode="clip").

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                  // ids per thread
constexpr int kChunk = kThreads * kPer;  // ids per block
constexpr int kWarps = kThreads / 32;
constexpr int kStageBytes = 32 * 1024;   // staged rows per pass

template <typename V>
__device__ __forceinline__ void stage_row_vec(V* dst, const V* src) {
  if constexpr (sizeof(V) >= 4) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
                 "n"((int)sizeof(V)));
  } else {
    *dst = __ldg(src);
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
    gather_sorted_kernel(const V* __restrict__ table, const I* __restrict__ ids,
                         V* __restrict__ out, long long n, int rows, int vecs, int cap) {
  __shared__ int s_slot[kChunk];       // the run of each id of the chunk
  __shared__ int s_row[kChunk];        // the clamped row of each run
  __shared__ int s_start[kChunk + 1];  // each run's first id; s_start[runs] = chunk length
  __shared__ int s_warp[kWarps];
  __shared__ __align__(16) unsigned char s_stage[kStageBytes];
  V* stage = reinterpret_cast<V*>(s_stage);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (long long base = (long long)blockIdx.x * kChunk; base < n;
       base += (long long)gridDim.x * kChunk) {
    const int len = (int)(n - base < kChunk ? n - base : kChunk);
    const int i0 = tid * kPer;
    int row[kPer];
    int heads = 0;
    unsigned head_bits = 0;
    int prev = -1;
    if (i0 > 0 && i0 < len) {
      long long r = (long long)ids[base + i0 - 1];
      prev = (int)(r < 0 ? 0 : (r >= rows ? rows - 1 : r));
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = i0 + u;
      row[u] = 0;
      if (i < len) {
        long long r = (long long)ids[base + i];
        row[u] = (int)(r < 0 ? 0 : (r >= rows ? rows - 1 : r));
        if (i == 0 || row[u] != prev) {
          head_bits |= 1u << u;
          ++heads;
        }
        prev = row[u];
      }
    }
    // block scan of the head counts: run numbers in id order
    int incl = heads;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int v = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += t;
      }
      if (lane < kWarps) s_warp[lane] = v;
    }
    __syncthreads();
    const int runs = s_warp[kWarps - 1];
    int run = incl - heads + (warp > 0 ? s_warp[warp - 1] : 0);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = i0 + u;
      if (i < len) {
        if (head_bits >> u & 1u) {
          s_row[run] = row[u];
          s_start[run] = i;
          ++run;
        }
        s_slot[i] = run - 1;
      }
    }
    if (tid == 0) s_start[runs] = len;
    __syncthreads();

    for (int p0 = 0; p0 < runs; p0 += cap) {
      const int p1 = runs - p0 < cap ? runs : p0 + cap;
      const int total = (p1 - p0) * vecs;
      for (int t = tid; t < total; t += kThreads) {
        const int u = t / vecs;
        stage_row_vec(stage + t, table + (long long)s_row[p0 + u] * vecs + (t - u * vecs));
      }
      stage_wait();
      __syncthreads();
      const int e0 = s_start[p0];
      const int wtotal = (s_start[p1] - e0) * vecs;
      V* dst = out + (base + e0) * vecs;
      for (int t = tid; t < wtotal; t += kThreads) {
        const int i = t / vecs;
        __stcs(dst + t, stage[(s_slot[e0 + i] - p0) * vecs + (t - i * vecs)]);
      }
      __syncthreads();  // the stage and the chunk's tables are rewritten next
    }
  }
}

template <typename V>
int launch(const void* table, const void* ids, int ids64, void* out, long long n, long long rows,
           long long row_bytes, cudaStream_t s) {
  const int vecs = (int)(row_bytes / (long long)sizeof(V));
  const int cap = kStageBytes / (vecs * (int)sizeof(V));
  long long blocks = (n + kChunk - 1) / kChunk;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;  // the grid strides past that
  if (ids64)
    gather_sorted_kernel<V, long long><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const V*>(table), static_cast<const long long*>(ids), static_cast<V*>(out), n,
        (int)rows, vecs, cap);
  else
    gather_sorted_kernel<V, int><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const V*>(table), static_cast<const int*>(ids), static_cast<V*>(out), n,
        (int)rows, vecs, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table [rows, row_bytes] bytes, ids [n] int32 (ids64 = 0) or int64, out
// [n, row_bytes]; rows below 2^31, a row of at most 32 KB (the staging
// buffer). Returns cudaGetLastError() after the launch.
int allset_gather_sorted(const void* table, const void* ids, int ids64, void* out, long long n,
                         long long rows, long long row_bytes, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n <= 0 || row_bytes <= 0) return (int)cudaGetLastError();
  if (rows <= 0 || rows > 0x7fffffffLL || row_bytes > kStageBytes)
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
