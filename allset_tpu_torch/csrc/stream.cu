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
// out = seed + the sum, [16, F] f32. All are bound by bytes.
//
// B5, B7 and B8's first16 read only what their sums use: each chunk's
// first 16 rows (a contiguous 16 F span), 16-byte vector loads straight
// into registers, no shared-memory stage, one launch (stream_rows_kernel):
// a thread block owns a few vectors of the span over every chunk, its
// threads sum runs of consecutive chunks in chunk order and add the runs
// in order (deterministic; no partials). The TPU probes streamed every
// row because they compared DMA mechanisms; the card's streaming rate is
// B8's fold to measure, whose function reads every row.
//
// B8's fold (stream_fold_kernel) streams every byte into shared memory by
// TMA bulk copies (cp.async.bulk) on a ring of kFoldStages slots, the
// card's counterpart of Mosaic's automatic pipeline, with the roles split:
// one producer warp keeps a copy in flight on every free slot (each slot a
// `full` mbarrier that the copy completes and an `empty` one that each
// consumer warp arrives on when done with it), and 8 consumer warps, no
// block-wide barrier per stage. Each consumer thread owns fixed 16-byte
// column vectors of the [16, F] span (thread t vectors t, t + 256, ...),
// reads them from each 16-row group of a stage with 16-byte shared loads
// and sums them in f32 registers (24 floats a thread at F 384). The fold's
// function depends on chunks only through the row count, so the grid is
// persistent (one block an SM) and block b of nb folds the 16-row groups
// [G b / nb, G (b + 1) / nb) of the G whole groups
// (ops/cuda_stream.py::fold_spans). Each block writes a [16, F] f32
// partial; stream_combine_kernel adds them to the seed in a fixed tree (32
// contiguous runs of partials a column, each in order, then the runs
// pairwise): the same bits from run to run. It bounds the fold by bytes:
// the whole of x once (0.120 ms at [524,288, 384] bf16 on an H100).
//
// B5's and B7's TPU kernels read a static slot 0 (`msc[0, :16]`), whose
// contents depend on when each DMA lands; these read each chunk's own
// rows. On input whose chunks all hold the same rows the two agree.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVB = 4, kUnroll = 8;  // B5, B7: vectors a block, chunks of loads in flight
// B8 fold: consumer threads, the ring's slots, the bytes a stage aims at
// (whole 16-row groups, one group at least), the most 16-byte vectors a
// consumer thread owns (a row of at most kFoldMaxV * 256 bytes)
constexpr int kFoldConsumers = 256, kFoldThreads = kFoldConsumers + 32;
constexpr int kFoldStages = 4;
constexpr unsigned kStageBytes = 24 * 1024;
constexpr int kFoldMaxV = 10;
constexpr int kCombCols = 8, kCombRuns = 32;  // combine: float4 columns a block, runs a column

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
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
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
  int F, chunk, nchunks;
};

struct FoldArgs {
  const void* x;
  long long groups;  // whole 16-row groups to fold
  int rowb;          // bytes a row (F * itemsize, a multiple of 16)
  int sg;            // 16-row groups a stage
  float* part;       // [gridDim.x][16 F]
};

// acc += the 16 bytes of raw as floats
template <typename T>
__device__ __forceinline__ void add16(float* acc, const uint4& raw) {
  const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < 16 / (int)sizeof(T); ++e) acc[e] += to_f(x[e]);
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

// B8 fold: block b folds the 16-row groups [G b / nb, G (b + 1) / nb)
// into its [16, F] f32 partial. Warp 8 is the producer: its lane 0 issues
// stage q's bulk copy into slot q % kFoldStages once the consumers have
// released the slot's previous stage; warps 0-7 consume. MV: the most
// 16-byte vectors a consumer thread owns (rowb <= MV * kFoldConsumers).
template <typename T, int MV>
__global__ void __launch_bounds__(kFoldThreads) stream_fold_kernel(FoldArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kFoldStages], empty[kFoldStages];
  constexpr int EV = 16 / sizeof(T);
  const int gvec = a.rowb;  // 16-byte vectors in a 16-row group
  const size_t gbytes = 16 * (size_t)a.rowb;
  const long long g0 = a.groups * blockIdx.x / gridDim.x;
  const long long g1 = a.groups * (blockIdx.x + 1) / gridDim.x;
  const int nst = (int)((g1 - g0 + a.sg - 1) / a.sg);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kFoldStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kFoldConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kFoldConsumers / 32) {  // the producer
    if (lane == 0) {
      const unsigned char* x = static_cast<const unsigned char*>(a.x);
      for (int q = 0; q < nst; ++q) {
        const int s = q % kFoldStages;
        if (q >= kFoldStages) mbar_wait(&empty[s], ((q / kFoldStages) - 1) & 1);
        const long long ga = g0 + (long long)q * a.sg;
        const unsigned bytes = (unsigned)(min((long long)a.sg, g1 - ga) * gbytes);
        mbar_expect(&full[s], bytes);
        bulk_copy(smem + s * a.sg * gbytes, x + ga * gbytes, bytes, &full[s]);
      }
    }
    return;
  }
  float acc[MV][EV];
#pragma unroll
  for (int k = 0; k < MV; ++k)
#pragma unroll
    for (int e = 0; e < EV; ++e) acc[k][e] = 0.f;
  for (int q = 0; q < nst; ++q) {
    const int s = q % kFoldStages;
    mbar_wait(&full[s], (q / kFoldStages) & 1);
    const int ng = (int)min((long long)a.sg, g1 - (g0 + (long long)q * a.sg));
    const uint4* st = reinterpret_cast<const uint4*>(smem + s * a.sg * gbytes);
    for (int g = 0; g < ng; ++g) {
#pragma unroll
      for (int k = 0; k < MV; ++k) {
        const int v = threadIdx.x + k * kFoldConsumers;
        if (v < gvec) add16<T>(acc[k], st[g * gvec + v]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the slot
  }
  float* out = a.part + (size_t)blockIdx.x * 16 * (a.rowb / sizeof(T));
#pragma unroll
  for (int k = 0; k < MV; ++k) {
    const int v = threadIdx.x + k * kFoldConsumers;
    if (v < gvec)
#pragma unroll
      for (int e = 0; e < EV; e += 4)
        *reinterpret_cast<float4*>(out + (size_t)v * EV + e) =
            make_float4(acc[k][e], acc[k][e + 1], acc[k][e + 2], acc[k][e + 3]);
  }
}

// out = seed + the nparts partials [nparts][n4] (float4 columns): block
// column c's kCombRuns threads each add a contiguous run of partials in
// order, then the runs are added pairwise in a fixed tree (the same bits
// from run to run)
__global__ void __launch_bounds__(kCombCols * kCombRuns)
    stream_combine_kernel(const float4* __restrict__ part, int nparts, int n4,
                          const float4* __restrict__ seed, float4* __restrict__ out) {
  __shared__ float4 red[kCombRuns][kCombCols];
  const int c = threadIdx.x % kCombCols, r = threadIdx.x / kCombCols;
  const int col = blockIdx.x * kCombCols + c;
  const int j0 = (int)((long long)nparts * r / kCombRuns);
  const int j1 = (int)((long long)nparts * (r + 1) / kCombRuns);
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < n4) {
#pragma unroll 8
    for (int j = j0; j < j1; ++j) {
      const float4 v = __ldcg(part + (size_t)j * n4 + col);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
  }
  red[r][c] = sum;
#pragma unroll
  for (int h = kCombRuns / 2; h > 0; h /= 2) {
    __syncthreads();
    if (r < h) {
      const float4 v = red[r + h][c];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
      red[r][c] = sum;
    }
  }
  if (r == 0 && col < n4) {
    const float4 s = seed[col];
    out[col] = make_float4(s.x + sum.x, s.y + sum.y, s.z + sum.z, s.w + sum.w);
  }
}

// B8 fold's launch shape for rows of rowb bytes: 16-row groups a stage,
// dynamic shared bytes and the kernel instance (null if the row is wider
// than kFoldMaxV * 256 bytes)
struct FoldCfg {
  int sg;
  size_t smem;
  const void* fn;
};

template <typename T>
FoldCfg fold_cfg(int rowb) {
  const size_t gbytes = 16 * (size_t)rowb;
  FoldCfg c{(int)(kStageBytes / gbytes > 0 ? kStageBytes / gbytes : 1), 0, nullptr};
  c.smem = (size_t)kFoldStages * c.sg * gbytes;
  const int v = (rowb + kFoldConsumers - 1) / kFoldConsumers;
  if (v <= 3)
    c.fn = (const void*)stream_fold_kernel<T, 3>;
  else if (v <= 6)
    c.fn = (const void*)stream_fold_kernel<T, 6>;
  else if (v <= kFoldMaxV)
    c.fn = (const void*)stream_fold_kernel<T, kFoldMaxV>;
  return c;
}

template <typename T>
int launch_fold(const void* x, long long groups, int F, int blocks, float* part,
                const float* seed, float* out, cudaStream_t s) {
  const int rowb = F * (int)sizeof(T);
  const FoldCfg c = fold_cfg<T>(rowb);
  if (c.fn == nullptr || blocks < 0 || (groups > 0 && (blocks == 0 || blocks > groups)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (groups > 0) {
    e = cudaFuncSetAttribute(c.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
    if (e != cudaSuccess) return (int)e;
    FoldArgs fa{x, groups, rowb, c.sg, part};
    void* args[] = {&fa};
    e = cudaLaunchKernel(c.fn, dim3(blocks), dim3(kFoldThreads), args, c.smem, s);
    if (e != cudaSuccess) return (int)e;
  }
  const int n4 = 4 * F;  // [16, F] f32 in float4 columns
  stream_combine_kernel<<<(n4 + kCombCols - 1) / kCombCols, kCombCols * kCombRuns, 0, s>>>(
      reinterpret_cast<const float4*>(part), groups > 0 ? blocks : 0, n4,
      reinterpret_cast<const float4*>(seed), reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

// B5, B7, B8's first16: one launch of stream_rows_kernel, no partials
template <typename T>
int launch_rows(Args a, int nsrc, const float* seed, float* out, cudaStream_t s) {
  if (a.chunk < 16) return (int)cudaErrorInvalidValue;
  const long long nvec = (long long)a.F * sizeof(T);
  const unsigned g = (unsigned)((nvec + kVB - 1) / kVB);
  if (nsrc == 1)
    stream_rows_kernel<T, 1><<<g, kThreads, 0, s>>>(a, seed, out);
  else
    stream_rows_kernel<T, 2><<<g, kThreads, 0, s>>>(a, seed, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// kind 0: B5 (a), 1: B7 (a and b), 2: B8 fold (a), 3: B8 first 16 rows
// (a). a, b: [rows, F] (dtype 0 = f32, 1 = bf16), read over nchunks
// chunks of `chunk` rows (a multiple of 16); seed, out [16, F] f32. Kinds
// 0, 1, 3: one launch. Kind 2: `blocks` fold blocks (one an SM,
// at most the nchunks * chunk / 16 groups), part [blocks, 16, F] f32
// scratch. F * itemsize a multiple of 16. Returns cudaGetLastError() after
// the launches.
int allset_stream(const void* a, const void* b, const void* seed, int F, int chunk, int nchunks,
                  int blocks, int kind, void* part, void* out, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t item = dtype == 0 ? 4 : 2;
  if (F <= 0 || (F * item) % 16 || chunk <= 0 || chunk % 16 || nchunks < 0 || kind < 0 ||
      kind > 3 || (kind == 1 && b == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* sd = static_cast<const float*>(seed);
  float* o = static_cast<float*>(out);
  if (kind == 2) {
    const long long groups = (long long)nchunks * (chunk / 16);
    float* p = static_cast<float*>(part);
    if (dtype == 0) return launch_fold<float>(a, groups, F, blocks, p, sd, o, s);
    return launch_fold<__nv_bfloat16>(a, groups, F, blocks, p, sd, o, s);
  }
  Args args{{a, b}, F, chunk, nchunks};
  const int nsrc = kind == 1 ? 2 : 1;
  if (dtype == 0) return launch_rows<float>(args, nsrc, sd, o, s);
  return launch_rows<__nv_bfloat16>(args, nsrc, sd, o, s);
}

}  // extern "C"
