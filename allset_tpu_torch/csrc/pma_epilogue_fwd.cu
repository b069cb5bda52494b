// K2 / K2R at HC 64, 128, 192 and, in bf16, 256: the fused PMA epilogue's
// forward (pallas_pma.py::_fwd_kernel, its R = 1 and R > 1 grids). The
// design note is in pma_epilogue.cuh.

#include "pma_epilogue.cuh"

namespace {

// K2's shared memory: the row-sum exchange and row statistics [2 NWARPS +
// 3][TM] f32, the two weight stages, two agg buffers [2][TM][SW] in T (a
// tile's A operands and its y reuse its buffer once its out0 is read) and
// their two mbarriers.
__host__ __device__ constexpr size_t fwd_stage_offset(int HC) {
  return (size_t)(2 * NWARPS + 3) * tm_of(HC) * 4;
}
template <typename T>
__host__ __device__ constexpr size_t fwd_smem_bytes(int HC, int SW) {
  return fwd_stage_offset(HC) + 2 * slab_bytes(HC, ksf_of(HC, false, sizeof(T))) +
         (size_t)2 * tm_of(HC) * SW * sizeof(T) + 16;
}

// --- K2's agg rows: cp.async copies that complete on an mbarrier --------
//
// Each thread's copies arrive on the buffer's mbarrier (count THREADS)
// once they land, so the block waits for its rows there and not through
// a cp.async group: the weight pipeline's group waits are then met by
// these copies too, but only from the first weight slab on, by which time
// they have had the tile's LN0 to land.

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
// an arrival on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// until the phase of the given parity has completed
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

template <typename T, int HC>
constexpr bool fwd_den_may_overflow() {
  return fwd_smem_bytes<T>(HC, agg_width<HC, false>(HC)) > SMEM_MAX;
}

// K2 / K2R: persistent blocks over the R * ceil(M / TM) (run, tile) items,
// item w = run * ntiles + tile, block b taking b, b + gridDim.x, ... Tile
// k of a block sits in agg buffer k % 2; the block issues the copies of
// tile k + 1 into the other buffer before tile k waits for its own, so
// those rows arrive during tile k's LN0. Every item is computed alike
// whatever block takes it, so run r's y is a single-run launch's on its
// slice bit for bit.
template <typename T, int HC, bool DG>
__global__ void __launch_bounds__(THREADS, 1) pma_fwd_kernel(Args<T> A0, int R) {
  constexpr int MT = mt_of(HC), TM = tm_of(HC), NT = HC / 64;
  constexpr int KS_F = ksf_of(HC, false, sizeof(T));
  extern __shared__ __align__(128) char smem[];
  const Lane<MT> ln;
  const int n0 = ln.w * (HC / 8), SW = agg_width<HC, DG>(A0.H);
  float* red = reinterpret_cast<float*>(smem);
  float* stat = red + 2 * NWARPS * TM;
  char* sB = smem + fwd_stage_offset(HC);
  T* buf = reinterpret_cast<T*>(sB + 2 * slab_bytes(HC, KS_F));  // [2][TM][SW]
  uint64_t* bar = reinterpret_cast<uint64_t*>(buf + 2 * TM * SW);
  const int ntiles = (A0.M + TM - 1) / TM, nwork = R * ntiles;
  if (threadIdx.x == 0) {
    mbar_init(bar, THREADS);
    mbar_init(bar + 1, THREADS);
  }
  __syncthreads();
  // item w's rows into buffer b, their first SW columns (HC with DG),
  // zeros past M: 16-byte copies by the whole block
  auto issue = [&](int w, int b) {
    constexpr int V = 16 / sizeof(T);
    const int row0 = (w % ntiles) * TM, nv = (DG ? HC : SW) / V;
    const T* src = A0.agg + (size_t)(w / ntiles) * A0.WP;
    T* dst = buf + b * TM * SW;
    for (int i = threadIdx.x; i < TM * nv; i += THREADS) {
      const int r = i / nv, c = i % nv, grow = row0 + r;
      cp16z(dst + r * SW + c * V, src + (size_t)(grow < A0.M ? grow : 0) * A0.lda + c * V,
            grow < A0.M);
    }
    cp_arrive(bar + b);
  };
  issue(blockIdx.x, 0);
  float X[MT][NT][4], P[MT][NT][4];
  int k = 0;
  for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++k) {
    const int b = k & 1;
    if (w + (int)gridDim.x < nwork) issue(w + gridDim.x, b ^ 1);
    const Args<T> A = at_run(A0, HC, w / ntiles);
    const int row0 = (w % ntiles) * TM;
    T* sT = buf + b * TM * SW;
    mbar_wait(bar + b, (k >> 1) & 1);
    uint64_t pos0, posL;
    fwd_chain<T, HC, false, DG, KS_F>(A, row0, sT, reinterpret_cast<char*>(sT), red, stat, sB,
                                      X, P, pos0, posL);
    // y through the buffer (the last product is done with it), then out
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ln.row(m, 2 * h);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = n0 + 8 * j + 2 * ln.t;
          float y[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            y[q] = round_to<T>(
                __fadd_rn(__fmul_rn(X[m][j][2 * h + q], A.g1[c + q]), A.b1[c + q]));
            if (A.relu && !(y[q] > 0.f)) y[q] = 0.f;
          }
          store2(sT + r * SW + c, y[0], y[1]);
        }
      }
    __syncthreads();
    store_tile(A, row0, TM, sT, SW, HC, A.out, A.ldg);
    __syncthreads();  // these reads before the buffer's next copies
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// K2/K2R: one persistent block per SM (at most one per item)
template <typename T, int HC, bool DG>
int launch_fwd_as(const Args<T>& A, int R, cudaStream_t s) {
  const size_t bytes = fwd_smem_bytes<T>(HC, agg_width<HC, DG>(A.H));
  cudaError_t e = cudaFuncSetAttribute(pma_fwd_kernel<T, HC, DG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const long long nwork = (long long)R * ((A.M + tm_of(HC) - 1) / tm_of(HC));
  const int grid = (int)(nwork < sm_count() ? nwork : sm_count());
  pma_fwd_kernel<T, HC, DG><<<grid, THREADS, bytes, s>>>(A, R);
  return (int)cudaGetLastError();
}

template <typename T, int HC>
int launch_fwd(const Args<T>& A, int R, cudaStream_t s) {
  if constexpr (fwd_den_may_overflow<T, HC>())
    if (fwd_smem_bytes<T>(HC, agg_width<HC, false>(A.H)) > SMEM_MAX)
      return launch_fwd_as<T, HC, true>(A, R, s);
  return launch_fwd_as<T, HC, false>(A, R, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (agg, gy, out, dagg). Parameters are
// float32; Wf [R, L, HC, HC] f32 ([in][out]); Wbt the same weights in
// bf16, transposed ([out][in]), on the bf16 path (null in f32). R runs
// folded into the width (R = 1: the single-run layout); WP is the per-run
// width. Returns 1 (cudaErrorInvalidValue) for an unsupported HC.
int allset_pma_epilogue_fwd(const void* agg, const void* seed, const void* g0,
                            const void* b0, const void* Wf, const void* Wbt,
                            const void* brff, const void* g1, const void* b1, void* out,
                            int M, int WP, int HC, int H, int L, int R, int relu, int dtype,
                            void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || R <= 0) return (int)cudaGetLastError();
#define FWD(T, HCV)                                                                        \
  if (HC == HCV)                                                                           \
    return launch_fwd<T, HCV>(make_args<T>(agg, nullptr, seed, g0, b0, Wf, Wbt, brff, g1, \
                                           b1, out, nullptr, nullptr, nullptr, M, WP, HC, \
                                           H, L, R, relu),                                \
                              R, s);
  // f32 at HC 256 runs on the warpgroup K2 (pma_epilogue_wg.cu), both
  // dtypes at 384 and 512 on the cluster K2 (pma_epilogue_cluster.cu)
  if (dtype == 0) {
    FWD(float, 64) FWD(float, 128) FWD(float, 192)
  } else {
    FWD(__nv_bfloat16, 64) FWD(__nv_bfloat16, 128) FWD(__nv_bfloat16, 192)
    FWD(__nv_bfloat16, 256)
  }
#undef FWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
