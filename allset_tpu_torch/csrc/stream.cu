// B5, B7, B8: the streaming probes.
//
// Replace the TPU round's read-rate probes:
//   B5 benchmarks/exp_segsum_ablate.py::_flat_kernel (kind 0): 8 chunks a
//      TPU grid block, copied in by a manual double-buffered DMA, acc[16,
//      F] += chunk[:16] as a surrogate;
//   B7 benchmarks/exp_segsum_ablate.py::_dual_kernel (kind 1): B5 over two
//      arrays at once, acc += a_chunk[:16] + b_chunk[:16];
//   B8 benchmarks/exp_autopipe.py::_kernel: one chunk a block through
//      Mosaic's automatic pipeline, each block folded 16 rows at a time
//      into acc[16, F] (kind 2, "fold") or its first 16 rows only (kind 3).
// out = seed + the sum, [16, F] f32.
//
// B5 and B7 read only what their sums use: each chunk's first 16 rows (a
// contiguous 16 F span), 16-byte vector loads straight into registers, no
// shared-memory stage, one launch: a thread block owns a few vectors of
// the span over every chunk, its threads sum runs of consecutive chunks in
// chunk order and add the runs in order (deterministic; no partials). The
// TPU probes streamed every row because they compared DMA mechanisms; the
// card's streaming rate is B8's fold to measure, whose function reads
// every row. B8 streams every byte of its chunks into shared memory: TMA
// bulk copies (cp.async.bulk, one per stage, issued by one thread) on a
// ring of 4 stages, each completing on its mbarrier, the card's
// counterpart of Mosaic's automatic pipeline (a stage is SR consecutive
// rows of a chunk: a 384-column bf16 chunk of 512 rows, 384 KB, fits no
// SM). All three are bound by bytes.
//
// B8's thread blocks each take a run of consecutive chunks (chunks /
// thread blocks of them, so the partials stay few beside the bytes read)
// and write a [16, F] f32 partial; a second pass adds the partials in
// block order to the seed: deterministic (on the TPU the sum was carried
// across the sequential grid). B5's and B7's TPU kernels read a static
// slot 0 (`msc[0, :16]`), whose contents depend on when each DMA lands;
// these read each chunk's own rows. On input whose chunks all hold the
// same rows the two agree.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTmaStages = 4;
constexpr int kVB = 4, kUnroll = 8;  // B5, B7: vectors a block, chunks of loads in flight
constexpr size_t kSmemBudget = 200 * 1024;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Args {
  const void* src[2];
  int nsrc, F, chunk, nchunks, cpb, sr, fold;  // cpb: chunks a thread block; sr: rows a stage
  float* part;  // [gridDim.x][16][F]
};

// acc (shared, [16][F] f32; thread i owns elements i, i + kThreads, ...)
// += the stage's rows (fold: every row r into acc[r % 16]; else rows 0-15)
template <typename T>
__device__ __forceinline__ void consume(float* acc, const T* stage, int F, int rows, bool fold) {
  for (int e = threadIdx.x; e < 16 * F; e += kThreads) {
    float v = acc[e];
    if (fold)
      for (int i = e; i < rows * F; i += 16 * F) v += to_f(stage[i]);
    else
      v += to_f(stage[e]);
    acc[e] = v;
  }
}

// B5, B7: out = seed + the first 16 rows of every chunk of nsrc sources,
// in one launch. A thread block owns kVB 16-byte vectors of the flattened
// [16, F] span over all chunks: thread (v, g) sums vector v of its run of
// consecutive chunks [g cpt, (g + 1) cpt) in chunk order, loaded straight
// into registers kUnroll / nsrc chunks at a time; the runs' sums are added
// in run order through shared memory (in groups of consecutive runs, then
// the groups in order)
template <typename T, int NSRC>
__global__ void __launch_bounds__(kThreads) stream_rows_kernel(Args a, const float* seed,
                                                             float* out) {
  constexpr int EV = 16 / sizeof(T), U = kUnroll / NSRC, G = kThreads / kVB;
  __shared__ float red[G][kVB * EV + 1];
  const long long nvec = (long long)a.F * sizeof(T);  // 16-byte vectors in 16 rows
  const int v = threadIdx.x % kVB, g = threadIdx.x / kVB;
  const long long vec = (long long)blockIdx.x * kVB + v;
  const int cpt = (a.nchunks + G - 1) / G, c0 = g * cpt, c1 = min(c0 + cpt, a.nchunks);
  float acc[EV];
#pragma unroll
  for (int e = 0; e < EV; ++e) acc[e] = 0.f;
  if (vec < nvec) {
    for (int c = c0; c < c1; c += U) {
      uint4 raw[U][NSRC];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int s = 0; s < NSRC; ++s)
          raw[u][s] = c + u < c1 ? __ldg(reinterpret_cast<const uint4*>(
                                            static_cast<const T*>(a.src[s]) +
                                            (long long)(c + u) * a.chunk * a.F) + vec)
                                 : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int s = 0; s < NSRC; ++s) {
          const T* x = reinterpret_cast<const T*>(&raw[u][s]);
#pragma unroll
          for (int e = 0; e < EV; ++e) acc[e] += to_f(x[e]);
        }
    }
  }
#pragma unroll
  for (int e = 0; e < EV; ++e) red[g][v * EV + e] = acc[e];
  __syncthreads();
  // the runs in order, in Q groups of G / Q runs, then the groups in order
  constexpr int NE = kVB * EV, Q = kThreads / NE;
  __shared__ float red2[Q][NE];
  const int e = threadIdx.x % NE, q = threadIdx.x / NE;
  float r = 0.f;
#pragma unroll
  for (int i = 0; i < G / Q; ++i) r += red[q * (G / Q) + i][e];
  red2[q][e] = r;
  __syncthreads();
  if (threadIdx.x < NE) {
    const long long el = (long long)blockIdx.x * NE + threadIdx.x;
    if (el < 16LL * a.F) {
      float o = seed[el];
#pragma unroll
      for (int i = 0; i < Q; ++i) o += red2[i][threadIdx.x];
      out[el] = o;
    }
  }
}

// B8: TMA bulk copies on a ring of kTmaStages stages
template <typename T>
__global__ void __launch_bounds__(kThreads) stream_tma_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kTmaStages];
  const size_t stage_elems = (size_t)a.sr * a.F;
  const unsigned stage_bytes = (unsigned)(stage_elems * sizeof(T));
  T* buf = reinterpret_cast<T*>(smem);  // [kTmaStages][sr][F]
  float* acc = reinterpret_cast<float*>(smem + kTmaStages * (size_t)stage_bytes);
  for (int e = threadIdx.x; e < 16 * a.F; e += kThreads) acc[e] = 0.f;
  const int c0 = blockIdx.x * a.cpb, c1 = min(c0 + a.cpb, a.nchunks);
  const int spc = a.chunk / a.sr, nst = (c1 - c0) * spc;
  const T* x = static_cast<const T*>(a.src[0]);
  auto issue = [&](int q) {
    const long long row0 = (long long)(c0 + q / spc) * a.chunk + (long long)(q % spc) * a.sr;
    uint64_t* bar = &full[q % kTmaStages];
    mbar_expect(bar, stage_bytes);
    bulk_copy(buf + (size_t)(q % kTmaStages) * stage_elems, x + row0 * a.F, stage_bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kTmaStages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int q = 0; q < kTmaStages && q < nst; ++q) issue(q);
  }
  __syncthreads();
  for (int q = 0; q < nst; ++q) {
    mbar_wait(&full[q % kTmaStages], (q / kTmaStages) & 1);
    if (a.fold || q % spc == 0)
      consume(acc, buf + (size_t)(q % kTmaStages) * stage_elems, a.F, a.sr, a.fold);
    __syncthreads();  // every thread is done with the slot
    if (threadIdx.x == 0 && q + kTmaStages < nst) issue(q + kTmaStages);
  }
  float* out = a.part + (size_t)blockIdx.x * 16 * a.F;
  for (int e = threadIdx.x; e < 16 * a.F; e += kThreads) out[e] = acc[e];
}

// out[e] = seed[e] + sum over the partials in block order
__global__ void __launch_bounds__(kThreads)
    stream_combine_kernel(const float* __restrict__ part, int nparts, int n,
                          const float* __restrict__ seed, float* __restrict__ out) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float v = seed[e];
  for (int j = 0; j < nparts; ++j) v += part[(size_t)j * n + e];
  out[e] = v;
}

// B8: the widest stage of whole rows, a power of two of at least 16 rows
// dividing the chunk, whose nstage copies (x nsrc) and the [16, F] f32
// accumulator fit the shared-memory budget; 0 if none
int stage_rows(int F, int chunk, int nstage, int nsrc, size_t item) {
  const size_t acc = 16 * (size_t)F * 4;
  int sr = 0;
  for (int r = 16; r <= chunk && chunk % r == 0; r *= 2)
    if (acc + (size_t)nstage * nsrc * r * F * item <= kSmemBudget) sr = r;
  return sr;
}

template <typename T>
int launch(Args a, int kind, const float* seed, float* out, cudaStream_t s) {
  const int grid = (a.nchunks + a.cpb - 1) / a.cpb;
  cudaError_t e;
  if (kind >= 2) {
    a.sr = stage_rows(a.F, a.chunk, kTmaStages, 1, sizeof(T));
    if (a.sr == 0) return (int)cudaErrorInvalidValue;
    a.fold = kind == 2;
    const size_t bytes = (size_t)kTmaStages * a.sr * a.F * sizeof(T) + 16 * (size_t)a.F * 4;
    e = cudaFuncSetAttribute(stream_tma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    if (grid > 0) stream_tma_kernel<T><<<grid, kThreads, bytes, s>>>(a);
  } else {  // B5, B7: one launch, no partials
    if (a.chunk < 16) return (int)cudaErrorInvalidValue;
    const long long nvec = (long long)a.F * sizeof(T);
    const unsigned g = (unsigned)((nvec + kVB - 1) / kVB);
    if (a.nsrc == 1)
      stream_rows_kernel<T, 1><<<g, kThreads, 0, s>>>(a, seed, out);
    else
      stream_rows_kernel<T, 2><<<g, kThreads, 0, s>>>(a, seed, out);
    return (int)cudaGetLastError();
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = 16 * a.F;
  stream_combine_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(a.part, grid, n, seed,
                                                                          out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// kind 0: B5 (a), 1: B7 (a and b), 2: B8 fold (a), 3: B8 first 16 rows (a).
// a, b: [rows, F] (dtype 0 = f32, 1 = bf16), read over nchunks chunks of
// `chunk` rows (at least 16); seed, out [16, F] f32; B8: cpb chunks a
// thread block, part [ceil(nchunks / cpb), 16, F] f32 scratch (B5 and B7
// take neither). F * itemsize a multiple of 16. Returns cudaGetLastError()
// after the launches.
int allset_stream(const void* a, const void* b, const void* seed, int F, int chunk, int nchunks,
                  int cpb, int kind, void* part, void* out, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t item = dtype == 0 ? 4 : 2;
  if (F <= 0 || (F * item) % 16 || chunk <= 0 || nchunks < 0 || cpb <= 0 || kind < 0 ||
      kind > 3 || (kind == 1 && b == nullptr))
    return (int)cudaErrorInvalidValue;
  Args args{{a, b}, kind == 1 ? 2 : 1, F, chunk, nchunks, cpb, 0, 0, static_cast<float*>(part)};
  const float* sd = static_cast<const float*>(seed);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch<float>(args, kind, sd, o, s);
  return launch<__nv_bfloat16>(args, kind, sd, o, s);
}

}  // extern "C"
