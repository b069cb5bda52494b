// B5, B7, B8: the streaming probes.
//
// Replace the TPU round's read-rate probes:
//   B5 benchmarks/exp_segsum_ablate.py::_flat_kernel (kind 0): 8 chunks a
//      block, copied in by a manual double-buffered DMA, acc[16, F] +=
//      chunk[:16] as a surrogate;
//   B7 benchmarks/exp_segsum_ablate.py::_dual_kernel (kind 1): B5 over two
//      arrays at once, 4 chunks a block, acc += a_chunk[:16] +
//      b_chunk[:16];
//   B8 benchmarks/exp_autopipe.py::_kernel: one chunk a block through
//      Mosaic's automatic pipeline, each block folded 16 rows at a time
//      into acc[16, F] (kind 2, "fold") or its first 16 rows only (kind 3).
// out = seed + the sum, [16, F] f32. Every probe reads every byte of its
// chunks into shared memory, whatever its surrogate reads from there: the
// point is the read rate, each array read once (bound by bytes).
//
// On the card thread blocks run in parallel, so each writes a [16, F] f32
// partial and a second pass adds the partials in block order to the seed:
// deterministic (on the TPU the sum was carried across the sequential
// grid). B5's and B7's thread block is the TPU's grid block (8 and 4
// chunks); B8's takes a run of consecutive chunks (chunks / thread blocks
// of them), so the partials stay few beside the bytes read.
//
// B5's and B7's surrogate reads the chunk just waited for; the TPU kernels
// read a static slot 0 (`msc[0, :16]`), whose contents depend on when each
// DMA lands. On input whose chunks all hold the same rows the two agree.
//
// Copy mechanisms, the comparison these probes exist for:
//   * B5, B7: cp.async (16 bytes a thread) into a double buffer, the
//     counterpart of the manual DMA; a stage is SR consecutive rows of a
//     chunk (a 384-column bf16 chunk of 512 rows, 384 KB, fits no SM);
//   * B8: TMA bulk copies (cp.async.bulk, one per stage, issued by one
//     thread) on a ring of 4 stages, each completing on its mbarrier: the
//     card's counterpart of Mosaic's automatic pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTmaStages = 4;
constexpr size_t kSmemBudget = 200 * 1024;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait0() { asm volatile("cp.async.wait_group 0;\n" ::); }

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

// B5, B7: cp.async double buffer, nsrc sources, first 16 rows of each chunk
template <typename T>
__global__ void __launch_bounds__(kThreads) stream_cp_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t stage_elems = (size_t)a.sr * a.F;
  T* buf = reinterpret_cast<T*>(smem);  // [2][nsrc][sr][F]
  float* acc = reinterpret_cast<float*>(smem + 2 * a.nsrc * stage_elems * sizeof(T));
  for (int e = threadIdx.x; e < 16 * a.F; e += kThreads) acc[e] = 0.f;
  const int c0 = blockIdx.x * a.cpb, c1 = min(c0 + a.cpb, a.nchunks);
  const int spc = a.chunk / a.sr, nst = (c1 - c0) * spc;
  const int nvec = (int)(stage_elems * sizeof(T) / 16), ev = 16 / sizeof(T);
  auto load = [&](int q) {
    const long long row0 = (long long)(c0 + q / spc) * a.chunk + (long long)(q % spc) * a.sr;
    for (int s = 0; s < a.nsrc; ++s) {
      const T* src = static_cast<const T*>(a.src[s]) + row0 * a.F;
      T* dst = buf + ((size_t)(q & 1) * a.nsrc + s) * stage_elems;
      for (int i = threadIdx.x; i < nvec; i += kThreads)
        cp16(dst + (size_t)i * ev, src + (size_t)i * ev);
    }
    cp_commit();
  };
  if (nst > 0) load(0);
  for (int q = 0; q < nst; ++q) {
    cp_wait0();
    __syncthreads();  // stage q landed for all; stage q - 1's reads are done
    if (q + 1 < nst) load(q + 1);
    if (q % spc == 0)  // the chunk's first stage holds its first 16 rows
      for (int s = 0; s < a.nsrc; ++s)
        consume(acc, buf + ((size_t)(q & 1) * a.nsrc + s) * stage_elems, a.F, a.sr, false);
  }
  float* out = a.part + (size_t)blockIdx.x * 16 * a.F;
  for (int e = threadIdx.x; e < 16 * a.F; e += kThreads) out[e] = acc[e];
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

// the widest stage of whole rows, a power of two of at least 16 rows
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
  const bool tma = kind >= 2;
  const int nstage = tma ? kTmaStages : 2;
  a.sr = stage_rows(a.F, a.chunk, nstage, a.nsrc, sizeof(T));
  if (a.sr == 0) return (int)cudaErrorInvalidValue;
  a.fold = kind == 2;
  const int grid = (a.nchunks + a.cpb - 1) / a.cpb;
  const size_t bytes =
      (size_t)nstage * a.nsrc * a.sr * a.F * sizeof(T) + 16 * (size_t)a.F * 4;
  cudaError_t e;
  if (tma) {
    e = cudaFuncSetAttribute(stream_tma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    if (grid > 0) stream_tma_kernel<T><<<grid, kThreads, bytes, s>>>(a);
  } else {
    e = cudaFuncSetAttribute(stream_cp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    if (grid > 0) stream_cp_kernel<T><<<grid, kThreads, bytes, s>>>(a);
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
// `chunk` rows, cpb chunks a thread block; seed, out [16, F] f32; part
// [ceil(nchunks / cpb), 16, F] f32 scratch. F * itemsize a multiple of 16.
// Returns cudaGetLastError() after the launches.
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
