// K2 / K2R at HC 384 and 512 on Hopper: the fused PMA epilogue's forward
// (allset_tpu/ops/pallas_pma.py::_fwd_kernel, its R = 1 and R > 1 grids)
// on a cluster of two blocks per 64-row tile. The contract and the forward
// chain are those of pma_epilogue.cuh; K2 at HC 256 in f32 is
// pma_epilogue_wg.cu's, at the other widths up to 256 pma_epilogue_fwd.cu's.
//
// What bounds it on the H100: the rFF products (2 L HC^2 flops a row, 1
// MFLOP at HC 512, L 2), and the weights, which do not fit beside a tile
// and stream from L2 once per tile. The tiled K2 took 32-row tiles at
// these widths (16 warps, HC / 16 columns a warp within a 128-register
// budget) and read both layers per tile: 64 KB a row in f32, 32 KB in
// bf16 at HC 512. A warpgroup of 64 columns over a 64-row tile, as K2 at
// HC 256 has, would need HC / 64 warpgroups in one block and more
// registers than a thread of it may have. The design:
//   * a cluster of two blocks takes a 64-row tile; block c owns the output
//     columns [c HC/2, (c + 1) HC/2): HC / 128 warpgroups of 64 columns,
//     each thread holding its [64, 64] share of every intermediate in the
//     wgmma accumulator layout (32 floats a thread per intermediate; zb
//     stays for the residual, packed as bf16 pairs on the bf16 path), as
//     K2 at HC 256 does;
//   * every product is a wgmma: bf16 m64n64k16 with A and B in shared
//     memory (A in wgmma's K-major core-matrix layout, one slab's products
//     in flight while the warpgroup waits for the next slab), f32 3xTF32
//     on m64n64k8 with A from registers (the error argument of
//     pma_epilogue.cuh). A spans all HC columns, so each block writes its
//     half of zb, and of round(relu(p0)), into its own A buffer and into
//     its peer's (distributed shared memory), and the pair passes a
//     cluster barrier before either reads it; a second barrier before
//     round(relu(p0)) overwrites zb;
//   * the weights stream through a ring of bulk copies (the TMA's linear
//     mode), each block only its N-half of every slab, laid out by the
//     wrapper as wgmma's K-major core matrices (ops/cuda_pma.py::
//     cluster_fwd_weights). The weight bytes a row are L HC^2 item / 64:
//     16 KB in bf16 and 32 KB in f32 at HC 512, L 2, half the tiled K2's.
//     bf16 slabs are B as they land (the last warp done with a slot
//     refills it). f32 slabs come as plain f32, 4 bytes an element, where
//     the 8-byte TF32 hi | lo slabs of K2 at HC 256 would leave the bytes
//     a row at the tiled K2's: the block splits each slab once, hi in
//     place and lo into one of two side buffers, while the previous slab's
//     products run, then passes a block barrier, after which thread 0
//     refills the slot those products released (the row partials share
//     the lo buffers, which leaves room for a ring of 4 at HC 512);
//   * row statistics (LN0, LN1): each thread's sums over its columns, the
//     t lanes by a shuffle tree, the block's warpgroups in order, then
//     block 0's partial plus block 1's, both read through distributed
//     shared memory, so the two blocks compute the same bits for a row;
//   * the block's half of a tile's agg values comes into its A buffer by
//     16-byte cp.async copies of all threads (zeros past M) arriving on an
//     mbarrier, the next item's as soon as the last product of the current
//     one is done with the buffer, while LN1 runs; the denominators are
//     read from global memory (through L1) once per row and head of a
//     thread's columns, so every head count runs at the same
//     shared-memory size;
//   * persistent: cluster i takes the (run, tile) items i, i + nclusters,
//     ...; the grid is the clusters that can be resident at once
//     (cudaOccupancyMaxActiveClusters), and a launch that none can be
//     raises. Every item is computed alike whatever cluster takes it, so
//     run r of K2R equals a K2 launch on run r's slice bit for bit; no
//     atomics touch a value.

#include "pma_cluster.cuh"

namespace {

template <typename T>
struct ClArgs {
  const T* agg;
  const float *seed, *g0, *b0, *brff, *g1, *b1;
  const char* wf;  // [R][2 halves][L][HC / KS][cl_slot]: each half's slabs of W^T
  T* y;
  int M, H, L, WP, relu;
  size_t lda, ldg;
};

// The block's shared memory: the ring of nst slots, the f32 slabs' two lo
// buffers, the A operand [64][HC + 4] f32 or [64][HC] bf16 in core
// matrices (a_off; first the staged agg values [64][HC / 2 + pad]), the
// warpgroups' row partials [HC / 128][2][64] and the block's [LN0, LN1][2
// statistics][64] (read by the peer; in f32 both inside the lo buffers),
// the mbarriers (each slot's, the stage's) and the slots' done counts.
// The ring takes what the rest leaves, at most WG_NST slots.
struct ClLayout {
  size_t lo, a, red, blk, bar, bytes;
  int nst;
};
template <typename T>
__host__ __device__ inline ClLayout cl_layout(int HC) {
  const size_t slot = cl_slot<T>(HC);
  const size_t lo = sizeof(T) == 4 ? 2 * slot : 0;
  const size_t a = (size_t)CL_TM * (HC + (sizeof(T) == 4 ? 4 : 0)) * sizeof(T);
  const size_t red = (size_t)(HC / 128) * 2 * CL_TM * 4, blk = 2 * 2 * CL_TM * 4;
  const size_t bars = (2 * WG_NST + 1) * 8;
  // f32: the row partials share the lo buffers, never in use together
  const size_t rest = lo + a + (lo ? 0 : red + blk) + bars;
  ClLayout S;
  const size_t room = SMEM_MAX > rest ? (SMEM_MAX - rest) / slot : 0;
  S.nst = room < WG_NST ? (int)room : WG_NST;
  S.lo = (size_t)S.nst * slot;
  S.a = S.lo + lo;
  S.red = lo ? S.lo : S.a + a;
  S.blk = S.red + red;
  S.bar = lo ? S.a + a : S.blk + blk;
  S.bytes = S.bar + bars;
  return S;
}

template <typename T, int HC>
__global__ void __launch_bounds__(HC, 1) pma_fwd_cluster_kernel(ClArgs<T> A, int R) {
  constexpr int NWG = HC / 128, HALF = HC / 2;
  constexpr bool BF = sizeof(T) == 2;
  constexpr int NS = HC / wg_ksf<T>();
  constexpr int LD = HC + 4;                   // the f32 A operand's row stride
  constexpr int SW = HALF + (BF ? 8 : 4);      // the staged values' row stride
  constexpr uint32_t SLOT = cl_slot<T>(HC);
  extern __shared__ __align__(128) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();  // the block's column half
  const int cid = blockIdx.x >> 1, ncl = gridDim.x >> 1;
  const ClLayout S = cl_layout<T>(HC);
  const uint32_t NST = S.nst;
  char* ring = smem;
  T* sA = reinterpret_cast<T*>(smem + S.a);
  T* pA = cluster.map_shared_rank(sA, c ^ 1);  // the peer's A buffer
  float* red = reinterpret_cast<float*>(smem + S.red);
  float* blk = reinterpret_cast<float*>(smem + S.blk);
  const float* blk0 = cluster.map_shared_rank(blk, 0);
  const float* blk1 = cluster.map_shared_rank(blk, 1);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S.bar);
  uint64_t* staged = full + NST;
  uint32_t* done = reinterpret_cast<uint32_t*>(staged + 1);
  const int ntiles = (A.M + CL_TM - 1) / CL_TM, nwork = R * ntiles;
  const int my_items = cid < nwork ? (nwork - 1 - cid) / ncl + 1 : 0;
  const uint32_t nseq = A.L * NS, total = my_items * nseq;
  auto fill = [&](uint32_t n) {  // slab n of the block's sequence into slot n % NST
    if (n >= total) return;
    const uint32_t slot = n % NST;
    const int run = (cid + (int)(n / nseq) * ncl) / ntiles;
    const char* src = A.wf + ((size_t)(run * 2 + c) * nseq + n % nseq) * SLOT;
    mbar_expect_tx(&full[slot], SLOT);
    bulk_load(ring + slot * SLOT, src, SLOT, &full[slot]);
  };
  // item k's agg values (this block's half of the columns) into the A
  // buffer as [64][SW] by all threads, 16-byte cp.async copies arriving on
  // the stage's mbarrier (zeros past M)
  auto stage = [&](int k) {
    constexpr int V = 16 / sizeof(T), NV = HALF / V;
    const int w = cid + k * ncl, row0 = (w % ntiles) * CL_TM;
    const T* src = A.agg + (size_t)(w / ntiles) * A.WP + c * HALF;
    for (int i = threadIdx.x; i < CL_TM * NV; i += HC) {
      const int r = i / NV, ch = i % NV, grow = row0 + r;
      cp16z(sA + r * SW + ch * V, src + (size_t)(grow < A.M ? grow : 0) * A.lda + ch * V,
            grow < A.M);
    }
    cp_arrive(staged);
  };
  if (threadIdx.x == 0) {
    for (uint32_t i = 0; i < NST; ++i) {
      mbar_init(&full[i], 1);
      done[i] = 0;
    }
    mbar_init(staged, HC);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster.sync();  // the peer has started: its shared memory may be written
  if (threadIdx.x == 0)
    for (uint32_t n = 0; n < NST; ++n) fill(n);
  if (my_items > 0) stage(0);
  const WgLane ln;
  const int n0 = c * HALF + ln.q * 64;  // the warpgroup's first column
  const float invC = (float)A.H / HC;
  uint32_t it = 0;
  float X[8][4], P[8][4];
  for (int k = 0; k < my_items; ++k) {
    const int w = cid + k * ncl, run = w / ntiles, row0 = (w % ntiles) * CL_TM;
    const T* agg = A.agg + (size_t)run * A.WP;
    if (threadIdx.x < 32 && k + 1 < my_items) {  // warp 0: the next item's rows into L2
      const int nx = w + ncl, nrow0 = (nx % ntiles) * CL_TM;
      for (int r = threadIdx.x; r < CL_TM && nrow0 + r < A.M; r += 32)
        prefetch_l2(A.agg + (size_t)(nx / ntiles) * A.WP + c * HALF + (size_t)(nrow0 + r) * A.lda,
                    HALF * sizeof(T));
    }
    const bool ok0 = row0 + ln.row(0) < A.M, ok1 = row0 + ln.row(2) < A.M;
    float pa[2] = {0.f, 0.f}, pb[2] = {0.f, 0.f};
    // 1. out0 (the staged values; den from global memory, once per row and
    // head of the thread's columns) and LN0 -> zb (in X)
    mbar_wait(staged, k & 1);
    {
      const float* seed = A.seed + (size_t)run * HC;
      int hd[2] = {-1, -1};  // per row: the head whose 1 / max(den, floor) is in dv
      float dv[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, r = ln.row(e), col = n0 + 8 * j + 2 * ln.t + (e & 1);
          const bool ok = h ? ok1 : ok0;
          // head col / C (C = HC / H columns a head) by a reciprocal: exact for col < 2^12
          const int head = (int)((col + 0.5f) * invC);
          if (head != hd[h]) {
            const float den = ok ? to_f(__ldg(agg + (size_t)(row0 + r) * A.lda + HC + head)) : 0.f;
            dv[h] = __frcp_rn(fmaxf(den, DEN_FLOOR));
            hd[h] = head;
          }
          const float v = ok ? to_f(sA[r * SW + col - c * HALF]) : 0.f;
          const float x = __fadd_rn(__fmul_rn(v, dv[h]), __ldg(seed + col));
          X[j][e] = x;
          pa[h] += x;
          pb[h] += x * x;
        }
    }
    cl_row_sum<NWG>(pa, pb, red, blk, blk0, blk1, 0, ln);
    {
      const float* g0 = A.g0 + (size_t)run * HC;
      const float* b0 = A.b0 + (size_t)run * HC;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mu = pa[h] / HC;
        const float rstd = rsqrtf(pb[h] / HC - mu * mu + EPS);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = n0 + 8 * j + 2 * ln.t + q;
            const float xh = __fmul_rn(__fsub_rn(X[j][2 * h + q], mu), rstd);
            X[j][2 * h + q] =
                round_to<T>(__fadd_rn(__fmul_rn(xh, __ldg(g0 + col)), __ldg(b0 + col)));
          }
      }
    }
    // both blocks read their staged values before the barrier above: zb
    // may overwrite them in either buffer
    cl_put_a<T, LD>(X, sA, pA, n0, ln);
    // bf16: zb, exact in bf16, kept packed through the products (frees 16
    // registers a thread there)
    uint32_t Z[BF ? 8 : 1][2];
    if constexpr (BF) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          Z[j][h] = pack_bf16(__float2bfloat16_rn(X[j][2 * h]),
                              __float2bfloat16_rn(X[j][2 * h + 1]));
    }
    cluster.sync();
    // 2. rFF with TorchDense rounding; p_l in P
    const float* brff = A.brff + (size_t)run * A.L * HC;
    for (int l = 0; l < A.L; ++l) {
      if constexpr (BF)
        cl_product_bf16<HC>(P, reinterpret_cast<const char*>(sA), ring, full, done, 4 * NWG,
                            it, NST, ln, fill);
      else
        cl_product_f32<HC>(P, reinterpret_cast<const char*>(sA), ring, smem + S.lo, full, it,
                           NST, ln, fill);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + 8 * j + 2 * ln.t + (e & 1);
          P[j][e] = round_to<T>(__fadd_rn(round_to<T>(P[j][e]), __ldg(brff + l * HC + col)));
        }
      if (l + 1 < A.L) {  // h_1 = relu(p_0), exact in T
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) P[j][e] = fmaxf(P[j][e], 0.f);
        cluster.sync();  // both blocks are done reading zb
        cl_put_a<T, LD>(P, sA, pA, n0, ln);
        cluster.sync();
      }
    }
    __syncthreads();  // this block is done with its A buffer: the next item's values
    if (k + 1 < my_items) stage(k + 1);
    // 3. out2 = zb + relu(p_L-1), LN1, y straight out (rows past M are not)
    pa[0] = pa[1] = pb[0] = pb[1] = 0.f;
    if constexpr (BF) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 z = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&Z[j][h]));
          X[j][2 * h] = z.x;
          X[j][2 * h + 1] = z.y;
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float o = __fadd_rn(X[j][e], fmaxf(P[j][e], 0.f));
        X[j][e] = o;
        pa[e >> 1] += o;
        pb[e >> 1] += o * o;
      }
    cl_row_sum<NWG>(pa, pb, red, blk, blk0, blk1, 1, ln);
    {
      const float* g1 = A.g1 + (size_t)run * HC;
      const float* b1 = A.b1 + (size_t)run * HC;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mu = pa[h] / HC;
        const float rstd = rsqrtf(pb[h] / HC - mu * mu + EPS);
        T* yr = A.y + (size_t)run * HC + (size_t)(row0 + ln.row(2 * h)) * A.ldg;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 + 8 * j + 2 * ln.t;
          float y[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float xh = __fmul_rn(__fsub_rn(X[j][2 * h + q], mu), rstd);
            y[q] = round_to<T>(
                __fadd_rn(__fmul_rn(xh, __ldg(g1 + col + q)), __ldg(b1 + col + q)));
            if (A.relu && !(y[q] > 0.f)) y[q] = 0.f;
          }
          if (h ? ok1 : ok0) store2(yr + col, y[0], y[1]);
        }
      }
    }
  }
  cluster.sync();  // the peer may still read this block's row partials
}

template <typename T, int HC>
int launch_fwd_cluster(const ClArgs<T>& A, int R, cudaStream_t s) {
  const ClLayout S = cl_layout<T>(HC);
  if (S.nst < 2) return (int)cudaErrorInvalidValue;  // a ring of 2 slots at least
  void (*kern)(ClArgs<T>, int) = pma_fwd_cluster_kernel<T, HC>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S.bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2, 1, 1);
  cfg.blockDim = dim3(HC, 1, 1);
  cfg.dynamicSmemBytes = S.bytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int resident = 0;  // clusters resident at once (the card's; asked once)
  if (resident == 0) {
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, (const void*)kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return (int)cudaErrorLaunchOutOfResources;  // no cluster fits
    resident = n;
  }
  const long long nwork = (long long)R * ((A.M + CL_TM - 1) / CL_TM);
  cfg.gridDim = dim3(2 * (unsigned)(nwork < resident ? nwork : resident), 1, 1);
  e = cudaLaunchKernelEx(&cfg, kern, A, R);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2/K2R at HC 384 and 512: inputs as allset_pma_epilogue_fwd's, with the
// weights as the column halves' slabs of ops/cuda_pma.py::
// cluster_fwd_weights in place of Wf and Wbt. Returns 1
// (cudaErrorInvalidValue) for another HC, and the launch's error where no
// cluster of two blocks can be resident.
int allset_pma_epilogue_fwd_cluster(const void* agg, const void* seed, const void* g0,
                                    const void* b0, const void* wf, const void* brff,
                                    const void* g1, const void* b1, void* out, int M, int WP,
                                    int HC, int H, int L, int R, int relu, int dtype,
                                    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || R <= 0) return (int)cudaGetLastError();
#define FWD_CL(T, HCV)                                                                      \
  if (HC == HCV) {                                                                          \
    ClArgs<T> A;                                                                            \
    A.agg = static_cast<const T*>(agg);                                                     \
    A.seed = static_cast<const float*>(seed);                                               \
    A.g0 = static_cast<const float*>(g0);                                                   \
    A.b0 = static_cast<const float*>(b0);                                                   \
    A.brff = static_cast<const float*>(brff);                                               \
    A.g1 = static_cast<const float*>(g1);                                                   \
    A.b1 = static_cast<const float*>(b1);                                                   \
    A.wf = static_cast<const char*>(wf);                                                    \
    A.y = static_cast<T*>(out);                                                             \
    A.M = M, A.H = H, A.L = L, A.WP = WP, A.relu = relu;                                    \
    A.lda = (size_t)R * WP;                                                                 \
    A.ldg = (size_t)R * HC;                                                                 \
    return launch_fwd_cluster<T, HCV>(A, R, s);                                             \
  }
  if (dtype == 0) {
    FWD_CL(float, 384) FWD_CL(float, 512)
  } else {
    FWD_CL(__nv_bfloat16, 384) FWD_CL(__nv_bfloat16, 512)
  }
#undef FWD_CL
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
