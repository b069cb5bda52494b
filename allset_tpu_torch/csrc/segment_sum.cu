// K1: sorted CSR segment-sum, out[m] = sum_{indptr[m] <= i < indptr[m+1]} msgs[i].
//
// Replaces allset_tpu/ops/pallas_segment.py::_kernel (the TPU one-hot MXU
// reduce). On the H100 the op is bound by bytes: it reads every message
// row once and writes every segment row once, with no reuse. Segment
// lengths are skewed (node 0 of the bench graph holds 64,855 of 451,178
// entries, and 120,634 of its 131,072 nodes hold none), so the work is
// split by entries and segment ends, not by segments:
//   * the chunk plan (graph/incidence.py::chunk_plan, built once per
//     indptr on the host) cuts the merge path of entries and segment ends
//     into chunks of at most 64 rows and 65 segments, ending where
//     possible at segment starts. A chunk writes the whole segments inside
//     it (empty ones as zeros) straight to the output and an f32 partial
//     row for a segment cut at its start (head_row) or only at its end
//     (tail_row); a second pass sums each cut segment's partials in chunk
//     order, staged through shared memory in batches of 64 rows. No
//     atomics: the result is deterministic;
//   * one thread per (chunk, 16-byte column vector), the threads of a
//     chunk side by side over the whole row, so a 33-vector bf16 row of
//     264 columns occupies 33 threads and no warp idles on a last tile;
//   * each thread sums its vector over the chunk's rows in f32, in row
//     order (four rows loaded ahead), and stores in the input dtype; an
//     empty segment stores zeros.
// Every column's sum is the same sequence of f32 additions whatever the
// width W, because the plan depends on indptr alone: a run folded into a
// [rows, R * W] table gets the bits of the run alone.
// W must be a multiple of 8 (264, 384, R * 264...).
//
// The gather inside K1 (allset_segment_sum_gather) replaces
// benchmarks/exp_fused_gather.py::_take_kernel (B11, jnp.take inside a
// kernel, the TPU round's probe for a fused exchange, which Mosaic could
// not lower). Row r of a chunk is then w[clamp(ids[r], 0, rows - 1)],
// times scale[run(column) * k + r] when a scale is given, the product
// rounded to the rows' dtype before the f32 sum, as the exchange's
// gather, scale and K1 round it in three launches (__fmul_rn: no FMA
// contraction). Everything else is K1's: the same plan, the same f32
// additions in row order, the same second pass. So the result is bit for
// bit that of B10, the scale and K1, and the [k, W] gathered table is
// never written and read back. The ids of a chunk are read by every
// thread of the chunk (the same addresses: one L1 line per warp), the
// row loads depend on them. Bound by bytes as K1: each id once, each
// gathered row once from L2 or memory, each segment row written once.
// A run r of the folded width takes the scale's row r (run_w columns a
// run, nruns runs; a column past the last run, the zero padding of a
// width that is not a multiple of 8, takes the last run's).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void add_vec(float* acc, uint4 v, float) {
  acc[0] += __uint_as_float(v.x);
  acc[1] += __uint_as_float(v.y);
  acc[2] += __uint_as_float(v.z);
  acc[3] += __uint_as_float(v.w);
}

__device__ __forceinline__ void add_vec(float* acc, uint4 v, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    acc[2 * i] += f.x;
    acc[2 * i + 1] += f.y;
  }
}

__device__ __forceinline__ void unpack(float* x, uint4 v, float) {
  x[0] = __uint_as_float(v.x);
  x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z);
  x[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack(float* x, uint4 v, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* acc) {
  *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* acc) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// V f32 values of a partial row (V = 4 or 8: one or two float4)
template <int V>
__device__ __forceinline__ void store_part(float* p, const float* acc) {
#pragma unroll
  for (int i = 0; i < V; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
}

template <int V>
__device__ __forceinline__ void add_part(float* acc, const float* p) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + i);
    acc[i] += f.x;
    acc[i + 1] += f.y;
    acc[i + 2] += f.z;
    acc[i + 3] += f.w;
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc[i] += round_T(x[i] * s[i]): the scaled row in the rows' dtype
template <typename T>
__device__ __forceinline__ void add_scaled(float* acc, uint4 v, const float* s) {
  constexpr int V = Vec<T>::N;
  float x[V];
  unpack(x, v, T());
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] += round_to(__fmul_rn(x[i], s[i]), T());
}

// Where pass 1 reads its rows: msgs[r] (K1), or the gathered w[ids[r]]
// with its optional scale (the gather inside K1).
template <typename T, typename I>
struct Gathered {
  const I* ids;
  const T* scale;  // [nruns, k] in the rows' dtype, or null
  long long rows;
  int k, run_w, nruns;
};

// Pass 1: thread (chunk c, vector v). chunks[c] = row0, row1, seg_lo,
// seg_hi, head_row, tail_row (graph/incidence.py::SegPlan).
template <typename T, typename I, bool GATHER>
__global__ void __launch_bounds__(kThreads)
segment_chunks_kernel(const T* __restrict__ msgs, Gathered<T, I> gs,
                      const int* __restrict__ indptr, const int* __restrict__ chunks,
                      int nchunks, int W, T* __restrict__ out, float* __restrict__ part) {
  constexpr int V = Vec<T>::N;
  const int nvec = W / V;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= (long long)nchunks * nvec) return;
  const int c = (int)(g / nvec), v = (int)(g % nvec);
  // the scale's row offset of each of this thread's V columns
  long long soff[V];
  bool one_run = true;
  if (GATHER && gs.scale) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      soff[i] = (long long)min((v * V + i) / gs.run_w, gs.nruns - 1) * gs.k;
      one_run &= soff[i] == soff[0];
    }
  }
  const int* ch = chunks + 6 * c;
  const int r0 = ch[0], r1 = ch[1], hi = ch[3], head_row = ch[4], tail_row = ch[5];
  int s = ch[2];
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  // store segment s's sum (its rows inside this chunk) and restart
  auto flush = [&](int seg) {
    const size_t col = (size_t)v * V;
    if (indptr[seg] < r0)
      store_part<V>(part + (size_t)head_row * W + col, acc);
    else if (indptr[seg + 1] > r1)
      store_part<V>(part + (size_t)tail_row * W + col, acc);
    else
      store_vec(out + (size_t)seg * W + col, acc);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
  };
  const T* p = msgs + (size_t)v * V;
  int seg_end = s < hi ? min(indptr[s + 1], r1) : r1;
  for (int r = r0; r < r1; r += 4) {
    const int nr = min(4, r1 - r);
    uint4 x[4];
    long long src[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      src[u] = r + u;
      if (GATHER && u < nr) {
        const long long id = (long long)gs.ids[r + u];
        src[u] = id < 0 ? 0 : (id >= gs.rows ? gs.rows - 1 : id);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < nr) x[u] = load16(p + (size_t)src[u] * W);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < nr) {
        while (r + u >= seg_end) {  // segment s ends before this row
          flush(s);
          ++s;
          seg_end = min(indptr[s + 1], r1);
        }
        if (GATHER && gs.scale) {
          float sc[V];
          if (one_run) {
            const float s0 = to_f(gs.scale[soff[0] + r + u]);
#pragma unroll
            for (int i = 0; i < V; ++i) sc[i] = s0;
          } else {
#pragma unroll
            for (int i = 0; i < V; ++i) sc[i] = to_f(gs.scale[soff[i] + r + u]);
          }
          add_scaled<T>(acc, x[u], sc);
        } else {
          add_vec(acc, x[u], T());
        }
      }
    }
  }
  for (; s < hi; ++s) flush(s);  // the last segment and trailing empty ones
}

// Pass 2: block (cut segment q, tile of kCombineVecs vectors). The
// segment's partial rows are staged in shared memory kCombineRows at a
// time, loaded by all threads at once; thread v of the tile then adds
// them in chunk order. A hot segment has ~1,000 partial rows: loaded one
// after the other by one thread, their latency would set the pass's time.
constexpr int kCombineRows = 64, kCombineVecs = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_combine_kernel(const float* __restrict__ part, const int* __restrict__ cuts,
                       int W, T* __restrict__ out) {
  constexpr int V = Vec<T>::N;
  __shared__ float4 buf[kCombineRows][kCombineVecs * 8 / 4];
  const int nvec = W / V, ntile = (nvec + kCombineVecs - 1) / kCombineVecs;
  const int q = blockIdx.x / ntile, v0 = (blockIdx.x % ntile) * kCombineVecs;
  const int seg = cuts[3 * q], first = cuts[3 * q + 1], count = cuts[3 * q + 2];
  const int nv = min(kCombineVecs, nvec - v0), nf4 = nv * V / 4;  // float4 per row
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  const float* p = part + (size_t)first * W + (size_t)v0 * V;
  for (int r0 = 0; r0 < count; r0 += kCombineRows) {
    const int nr = min(kCombineRows, count - r0);
    for (int i = threadIdx.x; i < nr * nf4; i += kThreads) {
      const int rr = i / nf4, f = i % nf4;
      buf[rr][f] = *reinterpret_cast<const float4*>(p + (size_t)(r0 + rr) * W + 4 * f);
    }
    __syncthreads();
    if (threadIdx.x < nv)
      for (int rr = 0; rr < nr; ++rr)
        add_part<V>(acc, reinterpret_cast<const float*>(&buf[rr][threadIdx.x * V / 4]));
    __syncthreads();
  }
  if (threadIdx.x < nv) store_vec(out + (size_t)seg * W + (size_t)(v0 + threadIdx.x) * V, acc);
}

template <typename T, typename I, bool GATHER>
int launch(const void* msgs, Gathered<T, I> gs, const void* indptr, const void* chunks,
           int nchunks, const void* cuts, int ncut, void* part, void* out, int W,
           cudaStream_t s) {
  const long long nvec = W / Vec<T>::N;
  const long long n1 = nchunks * nvec;
  const long long n2 = ncut * ((nvec + kCombineVecs - 1) / kCombineVecs);
  if (n1 > 0) {
    segment_chunks_kernel<T, I, GATHER>
        <<<(unsigned)((n1 + kThreads - 1) / kThreads), kThreads, 0, s>>>(
            static_cast<const T*>(msgs), gs, static_cast<const int*>(indptr),
            static_cast<const int*>(chunks), nchunks, W, static_cast<T*>(out),
            static_cast<float*>(part));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (n2 > 0)
    segment_combine_kernel<T><<<(unsigned)n2, kThreads, 0, s>>>(
        static_cast<const float*>(part), static_cast<const int*>(cuts), W,
        static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T, typename I>
int launch_gather(const void* w, long long rows, const void* ids, const void* scale, int k,
                  int run_w, int nruns, const void* indptr, const void* chunks, int nchunks,
                  const void* cuts, int ncut, void* part, void* out, int W, cudaStream_t s) {
  const Gathered<T, I> gs{static_cast<const I*>(ids), static_cast<const T*>(scale), rows, k,
                          run_w, nruns};
  return launch<T, I, true>(w, gs, indptr, chunks, nchunks, cuts, ncut, part, out, W, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. part: [num_partials, W] f32 scratch.
// Returns cudaGetLastError() after the launches.
int allset_segment_sum(const void* msgs, const void* indptr, const void* chunks,
                       int nchunks, const void* cuts, int ncut, void* part, void* out,
                       int W, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (W <= 0) return (int)cudaGetLastError();
  if (dtype == 0)
    return launch<float, int, false>(msgs, {}, indptr, chunks, nchunks, cuts, ncut, part, out,
                                     W, s);
  return launch<__nv_bfloat16, int, false>(msgs, {}, indptr, chunks, nchunks, cuts, ncut, part,
                                           out, W, s);
}

// The gather inside K1: out[m] = sum over indptr[m] <= r < indptr[m+1] of
// w[clamp(ids[r])] (times scale[min(col / run_w, nruns - 1) * k + r],
// rounded to the dtype, where scale is not null). w [rows, W], ids [k]
// int32 (ids64 = 0) or int64, scale [nruns, k] in w's dtype.
int allset_segment_sum_gather(const void* w, long long rows, const void* ids, int ids64,
                              const void* scale, int k, int run_w, int nruns,
                              const void* indptr, const void* chunks, int nchunks,
                              const void* cuts, int ncut, void* part, void* out, int W,
                              int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (W <= 0) return (int)cudaGetLastError();
  if (rows <= 0 || run_w <= 0 || nruns <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (ids64)
      return launch_gather<float, long long>(w, rows, ids, scale, k, run_w, nruns, indptr,
                                             chunks, nchunks, cuts, ncut, part, out, W, s);
    return launch_gather<float, int>(w, rows, ids, scale, k, run_w, nruns, indptr, chunks,
                                     nchunks, cuts, ncut, part, out, W, s);
  }
  if (ids64)
    return launch_gather<__nv_bfloat16, long long>(w, rows, ids, scale, k, run_w, nruns, indptr,
                                                   chunks, nchunks, cuts, ncut, part, out, W, s);
  return launch_gather<__nv_bfloat16, int>(w, rows, ids, scale, k, run_w, nruns, indptr, chunks,
                                           nchunks, cuts, ncut, part, out, W, s);
}

const char* allset_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
