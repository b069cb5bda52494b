// K3 / K3R at HC 384 and 512 on Hopper: the fused PMA epilogue's backward
// (allset_tpu/ops/pallas_pma.py::_bwd_kernel, its R = 1 and R > 1 grids).
// K3a, the row pass, runs on the cluster layout of K2 at these widths
// (pma_epilogue_cluster.cu; the code both share is in pma_cluster.cuh),
// K3b on the transposed scratch (pma_wgmma.cuh::dw_wg_kernel, as at HC
// 256), K3c is pma_epilogue.cuh's reduce. The contract and the chain are
// those of pma_epilogue.cuh; K3 at HC 256 is pma_epilogue_wg.cu's, at 64 to
// 192 pma_epilogue.cu's.
//
// What bounds it on the H100: the rFF products, four per row in the row
// pass at L = 2 (two forward, two dp @ W^T in 3xTF32), and the weights,
// which do not fit beside a tile and stream from L2 once per tile. The
// tiled K3 took 32-row tiles here and read all four matrices per tile
// (128 KiB a row in f32 at HC 512). The design:
//   * a cluster of two blocks takes a 64-row tile; block c owns the output
//     columns [c HC/2, (c + 1) HC/2) as HC / 128 warpgroups of 64 columns,
//     each thread holding its [64, 64] share of every intermediate in the
//     wgmma accumulator layout, as K2 here and K3a at HC 256 do. Each block
//     streams only its column half of each product's weights, so the
//     weight bytes a row are 2 L HC^2 * 4 / 64 per block pair in f32 (64
//     KiB at HC 512, L 2), half the tiled K3's;
//   * the forward recompute is the cluster K2's chain: zb and
//     round(relu(p0)) halves into both blocks' A buffers (distributed
//     shared memory), the LN0 and LN1 statistics block 0's partial plus
//     block 1's. The backward exchanges the same way: the LN1 backward's
//     two row sums, the dp_l halves (A of dp_l @ W_l^T spans all HC
//     columns; f32, 3xTF32), the LN0 backward's row sums. Every exchange
//     passes a cluster barrier: 10 a tile at L = 2 (11 where a head
//     straddles the halves); four are split into their arrival and their
//     wait, with the stores of h_l, dp_l and the small-vector partials
//     between (cl_arrive, cl_row_part);
//   * the ring: one sequence of slabs per block, each of 32 HC bytes, in
//     the order the products take them (forward l = 0..L-1: W^T's column
//     half, bf16 in CB_KSB k-rows or plain f32 in WG_KSF; then backward
//     l = L-1..0: W's row half, plain f32), laid out by the wrapper as
//     wgmma's K-major core matrices (ops/cuda_pma.py::cluster_bwd_weights).
//     f32 slabs are split into TF32 hi and lo in shared memory (the
//     cluster K2's cl_product_f32), bf16 slabs read as they land; the
//     slot's done count serves both kinds;
//   * the tile's agg values (twice: LN0 forward, then its backward and
//     dagg) and gy come into the block's A buffer as its column half, by
//     16-byte cp.async copies arriving on an mbarrier, whenever the A
//     buffer is free of this block's products; the peer writes into it only
//     after the row-sum exchange that follows the block's last read. The
//     denominators are read from global memory (cb_vals: once per row
//     where a head spans whole warpgroups, else per column pair or
//     column), so every head count runs;
//   * dden: the per-head sums of dout0 * vals over the block's columns
//     (through shared memory, a thread per row and head); a head that
//     straddles the halves (H = 1, or HC / 2 not a multiple of HC / H) is
//     block 0's partial plus block 1's, written by block 0;
//   * the small-vector gradients (dseed, dg0, db0, dg1, db1, dbrff) are
//     column sums over each warp's 16 rows, kept per warp in global
//     partials (part_small [R][4 NE][8][HC], NE = min(tiles, 66)): tile t's
//     sums go to entry (t % NE, warp), added in tile order, so K3c reduces
//     them unchanged. Cluster i of the NE walks the (run, tile) items i, i
//     + NE, ..., so every entry has one cluster and the same tiles in the
//     same order whatever R is: run r of K3R equals a K3 launch on run r's
//     slice bit for bit. No floating-point atomics;
//   * h_l and dp_l are written transposed, [L, HC, Mp], each block its
//     column half, for K3b.

#include "pma_cluster.cuh"

// CB_PHASES (defined only by scripts/k3_parts.py --phases, which builds this
// file apart): thread 0 of each block adds the clocks since its last stamp
// to the counter of the phase that ends there; allset_cb_phases reads the
// sums over the blocks
#ifdef CB_PHASES
__device__ unsigned long long cb_total[12];
#define CB_STAMP(k)                    \
  if (threadIdx.x == 0) {              \
    const long long now = clock64();   \
    cb_acc[k] += now - cb_last;        \
    cb_last = now;                     \
  }
#else
#define CB_STAMP(k)
#endif

namespace {

constexpr int CB_KSB = 32;  // k rows of a bf16 forward slab: the bytes of an f32 one
constexpr int CB_TABS = 8;  // the rows of a small-vector partial (pma_epilogue.cuh)
// the partials' entries per run: 66 clusters of two, the H100's 132 SMs
// (ops/cuda_pma.py::CLUSTER_BWD_ENTRIES sizes them)
constexpr int CB_ENTRIES = 66;

// a ring slot, either kind of slab: WG_KSF f32 k-rows (or CB_KSB bf16) of
// a block's HC / 2 columns
__host__ __device__ constexpr uint32_t cb_slot(int HC) { return (uint32_t)WG_KSF * (HC / 2) * 4; }

template <typename T>
struct CbArgs {
  const T* agg;
  const T* gy;
  const float *seed, *g0, *b0, *brff, *g1, *b1;
  const char* wf;  // [R][2 halves][L][HC / KS][slot]: W^T's column halves
  const char* wb;  // [R][2 halves][L][HC / WG_KSF][slot]: W's row halves, f32
  T* dagg;
  T* hT;              // [R][L][HC][Mp] rFF inputs
  float* dpT;         // [R][L][HC][Mp] rFF output gradients
  float* part_small;  // [R][4 NE][8][HC]
  int M, Mp, H, L, WP, relu, NE;
  size_t lda, ldg;
};

// The block's shared memory: the ring of nst slots, two lo buffers (the
// f32 slabs' TF32 lo parts; between products also the warpgroups' row
// partials [HC / 128][2][64], the block's [4 exchanges][2][64] statistics
// and the straddling head's [64] partials, both read by the peer), the A
// buffer (the f32 A operand [64][HC + 4]; in turn the staged agg values or
// gy [64][HC / 2 + pad] in T, the bf16 A operand [64][HC] in core
// matrices, dout0 * vals [64][HC / 2 + 4] f32), the mbarriers (each
// slot's, the stage's) and the slots' done counts. The ring takes what the
// rest leaves, at most WG_NST slots.
struct CbLayout {
  size_t lo, a, red, blk, ddx, bar, bytes;
  int nst;
};
__host__ __device__ inline CbLayout cb_layout(int HC) {
  const size_t slot = cb_slot(HC), lo = 2 * slot;
  const size_t a = (size_t)CL_TM * (HC + 4) * 4;
  const size_t bars = (2 * WG_NST + 1) * 8;
  const size_t rest = lo + a + bars;
  CbLayout S;
  const size_t room = SMEM_MAX > rest ? (SMEM_MAX - rest) / slot : 0;
  S.nst = room < WG_NST ? (int)room : WG_NST;
  S.lo = (size_t)S.nst * slot;
  S.a = S.lo + lo;
  S.red = S.lo;
  S.blk = S.red + (size_t)(HC / 128) * 2 * CL_TM * 4;
  S.ddx = S.blk + 4 * 2 * CL_TM * 4;
  S.bar = S.a + a;
  S.bytes = S.bar + bars;
  return S;
}

// Tile rows of an [HC][Mp] transposed table at the warpgroup's columns
// from n0 (rows past M as zeros, none past Mp).
template <typename T>
__device__ __forceinline__ void cb_store_t(const float (&x)[8][4], T* dst, int n0, int row0, int M,
                                           int Mp, const WgLane& ln) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int grow = row0 + ln.row(2 * h);
    if (grow >= Mp) continue;
    const bool ok = grow < M;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        dst[(size_t)(n0 + 8 * j + 2 * ln.t + q) * Mp + grow] = from_f<T>(ok ? x[j][2 * h + q] : 0.f);
  }
}

// The warp's partial of one small vector at its warpgroup's 64 columns
// (part): the sum over the warp's 16 rows of f(j, e) (the thread's two
// rows, then a shuffle tree over g, whose every lane ends with the same
// bits), stored (first) or added to what the warp stored for its earlier
// tiles. Lane (g, t) owns columns 8 g + 2 t and + 1: one float2 a lane.
template <typename F>
__device__ __forceinline__ void cb_col_add(F f, float* part, bool first, const WgLane& ln) {
  float v[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float s = f(j, q) + f(j, q + 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (j == ln.g) v[q] = s;
    }
  float2* p = reinterpret_cast<float2*>(part + 8 * ln.g + 2 * ln.t);
  if (!first) {
    const float2 o = *p;
    v[0] = o.x + v[0];
    v[1] = o.y + v[1];
  }
  *p = make_float2(v[0], v[1]);
}

// f(j, e, col, v, dinv) over the thread's share: v the staged value at
// its row and column col (0 past M), dinv = 1 / max(den, floor) of its
// head, den read from global memory. Where a head spans whole 64-column
// warpgroups (HC / H a multiple of 64: 8 heads or fewer at HC 512) the
// thread's columns share one head, read once per row; where it spans an
// even number of columns, once per row and column pair; otherwise once per
// element. (A cache of the last head read, branching per element, spilled
// most of the kernel's registers.)
template <typename T, int HC, typename F>
__device__ __forceinline__ void cb_vals(const T* st, const T* agg, size_t lda, int row0, bool ok0,
                                        bool ok1, int n0, int c, int H, const WgLane& ln, F f) {
  constexpr int HALF = HC / 2, SW = HALF + (sizeof(T) == 2 ? 8 : 4);
  const int C = HC / H;
  auto val = [&](int e, int col) {
    return (e >> 1 ? ok1 : ok0) ? to_f(st[ln.row(e) * SW + col - c * HALF]) : 0.f;
  };
  auto dinv = [&](int e, int head) {
    const bool ok = e >> 1 ? ok1 : ok0;
    const float den =
        ok ? to_f(__ldg(agg + (size_t)(row0 + ln.row(e)) * lda + HC + head)) : 0.f;
    return __frcp_rn(fmaxf(den, DEN_FLOOR));
  };
  if (C % 64 == 0) {
    const float dv[2] = {dinv(0, n0 / C), dinv(2, n0 / C)};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + 8 * j + 2 * ln.t + (e & 1);
        f(j, e, col, val(e, col), dv[e >> 1]);
      }
  } else if (C % 2 == 0) {  // columns 2 t and 2 t + 1 in one head
    // head col / C by a reciprocal: exact for col < 2^12
    const float invC = (float)H / HC;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + 8 * j + 2 * ln.t, head = (int)((col + 0.5f) * invC);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d = dinv(2 * h, head);
        f(j, 2 * h, col, val(2 * h, col), d);
        f(j, 2 * h + 1, col + 1, val(2 * h + 1, col + 1), d);
      }
    }
  } else {
    const float invC = (float)H / HC;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + 8 * j + 2 * ln.t + (e & 1);
        f(j, e, col, val(e, col), dinv(e, (int)((col + 0.5f) * invC)));
      }
  }
}

// two consecutive f32 parameters (an even column) through the read-only path
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ float cb_dden(float sm, float den) {
  const float dinv = 1.f / fmaxf(den, DEN_FLOOR);
  return den > DEN_FLOOR ? -sm * (dinv * dinv) : 0.f;
}

template <typename T, int HC>
__global__ void __launch_bounds__(HC, 1) pma_bwd_cluster_kernel(CbArgs<T> A, int R) {
  constexpr int NWG = HC / 128, HALF = HC / 2;
  constexpr bool BF = sizeof(T) == 2;
  constexpr int NSF = HC / (BF ? CB_KSB : WG_KSF), NSB = HC / WG_KSF;
  constexpr int LD = HC + 4;                // the f32 A operand's row stride
  constexpr int SW = HALF + (BF ? 8 : 4);   // the staged rows' stride
  constexpr int SF = HALF + 4;              // dout0 * vals' row stride
  constexpr uint32_t SLOT = cb_slot(HC), NWARPS = 4 * NWG;
  extern __shared__ __align__(128) char smem[];
#ifdef CB_PHASES
  __shared__ long long cb_acc[12], cb_last;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 12; ++i) cb_acc[i] = 0;
    cb_last = clock64();
  }
#endif
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();  // the block's column half
  const int cid = blockIdx.x >> 1, ncl = gridDim.x >> 1;
  const CbLayout S = cb_layout(HC);
  const uint32_t NST = S.nst;
  char* ring = smem;
  char* lobuf = smem + S.lo;
  char* sA = smem + S.a;
  T* sT = reinterpret_cast<T*>(sA);  // staged rows; the A operand in T
  float* sF = reinterpret_cast<float*>(sA);
  T* pT = cluster.map_shared_rank(sT, c ^ 1);  // the peer's A buffer
  float* pF = cluster.map_shared_rank(sF, c ^ 1);
  float* red = reinterpret_cast<float*>(smem + S.red);
  float* blk = reinterpret_cast<float*>(smem + S.blk);
  const float* blk0 = cluster.map_shared_rank(blk, 0);
  const float* blk1 = cluster.map_shared_rank(blk, 1);
  float* ddx = reinterpret_cast<float*>(smem + S.ddx);
  const float* ddx1 = cluster.map_shared_rank(ddx, 1);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S.bar);
  uint64_t* staged = full + NST;
  uint32_t* done = reinterpret_cast<uint32_t*>(staged + 1);
  const int ntiles = (A.M + CL_TM - 1) / CL_TM, nwork = R * ntiles;
  const int my_items = cid < nwork ? (nwork - 1 - cid) / ncl + 1 : 0;
  const uint32_t nseq = A.L * (NSF + NSB), total = my_items * nseq;
  auto fill = [&](uint32_t n) {  // slab n of the block's sequence into slot n % NST
    if (n >= total) return;
    const uint32_t slot = n % NST, u = n % nseq;
    const int run = (cid + (int)(n / nseq) * ncl) / ntiles;
    const char* src;
    if (u < A.L * NSF) {
      src = A.wf + ((size_t)(run * 2 + c) * A.L * NSF + u) * SLOT;
    } else {
      const uint32_t u2 = u - A.L * NSF;
      src = A.wb + ((size_t)(run * 2 + c) * A.L * NSB + (A.L - 1 - u2 / NSB) * NSB + u2 % NSB) *
                       SLOT;
    }
    mbar_expect_tx(&full[slot], SLOT);
    bulk_load(ring + slot * SLOT, src, SLOT, &full[slot]);
  };
  // rows [row0, row0 + 64) of src's column half (agg values or gy) into the
  // stage [64][SW] by all threads, 16-byte cp.async copies arriving on its
  // mbarrier (zeros past M)
  auto stage = [&](const T* src, size_t ld, int row0) {
    constexpr int V = 16 / sizeof(T), NV = HALF / V;
    for (int i = threadIdx.x; i < CL_TM * NV; i += HC) {
      const int r = i / NV, ch = i % NV, grow = row0 + r;
      cp16z(sT + r * SW + ch * V, src + (size_t)(grow < A.M ? grow : 0) * ld + ch * V,
            grow < A.M);
    }
    cp_arrive(staged);
  };
  uint32_t nstaged = 0;  // the stage's uses alternate the parity of its barrier
  auto wait_staged = [&]() {
    mbar_wait(staged, nstaged & 1);
    ++nstaged;
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
  if (my_items > 0)
    stage(A.agg + (size_t)(cid / ntiles) * A.WP + c * HALF, A.lda, (cid % ntiles) * CL_TM);
  const WgLane ln;
  const int n0 = c * HALF + ln.q * 64;  // the warpgroup's first column
  uint32_t it = 0;
  float X[8][4], P[8][4];
  for (int k = 0; k < my_items; ++k) {
    const int w = cid + k * ncl, run = w / ntiles, tile = w % ntiles, row0 = tile * CL_TM;
    const T* agg = A.agg + (size_t)run * A.WP;
    const float* g0 = A.g0 + (size_t)run * HC;
    const float* g1 = A.g1 + (size_t)run * HC;
    const size_t tab_off = (size_t)run * A.L * HC * A.Mp;
    // the warp's partials: entry (tile % NE, warp) of the run
    float* part = A.part_small + ((size_t)run * 4 * A.NE + (tile % A.NE) * 4 + ln.w) * CB_TABS * HC + n0;
    const bool first = tile < A.NE;
    if (threadIdx.x < 32 && k + 1 < my_items) {  // warp 0: the next item's rows into L2
      const int nx = w + ncl, nrun = nx / ntiles, nrow0 = (nx % ntiles) * CL_TM;
      for (int r = threadIdx.x; r < CL_TM && nrow0 + r < A.M; r += 32) {
        prefetch_l2(A.agg + (size_t)nrun * A.WP + c * HALF + (size_t)(nrow0 + r) * A.lda,
                    HALF * sizeof(T));
        prefetch_l2(A.gy + (size_t)nrun * HC + c * HALF + (size_t)(nrow0 + r) * A.ldg,
                    HALF * sizeof(T));
      }
    }
    const bool ok0 = row0 + ln.row(0) < A.M, ok1 = row0 + ln.row(2) < A.M;
    float pa[2] = {0.f, 0.f}, pb[2] = {0.f, 0.f}, mu0[2], rs0[2], rs1[2];
    uint32_t pos0 = 0, posL = 0;  // p_0 > 0 and p_L-1 > 0, bit 4 j + e
    // 1. out0 (the staged values) and LN0 -> zb (in X)
    wait_staged();
    CB_STAMP(0);
    {
      const float* seed = A.seed + (size_t)run * HC;
      cb_vals<T, HC>(sT, agg, A.lda, row0, ok0, ok1, n0, c, A.H, ln,
                     [&](int j, int e, int col, float v, float dinv) {
                       const float x = __fadd_rn(__fmul_rn(v, dinv), __ldg(seed + col));
                       X[j][e] = x;
                       pa[e >> 1] += x;
                       pb[e >> 1] += x * x;
                     });
    }
    cl_row_sum<NWG>(pa, pb, red, blk, blk0, blk1, 0, ln);
    {
      const float* b0 = A.b0 + (size_t)run * HC;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mu0[h] = pa[h] / HC;
        rs0[h] = rsqrtf(pb[h] / HC - mu0[h] * mu0[h] + EPS);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 + 8 * j + 2 * ln.t;
          const float2 g = ldg2(g0 + col), b = ldg2(b0 + col);
          const float gq[2] = {g.x, g.y}, bq[2] = {b.x, b.y};
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float xh = __fmul_rn(__fsub_rn(X[j][2 * h + q], mu0[h]), rs0[h]);
            X[j][2 * h + q] = round_to<T>(__fadd_rn(__fmul_rn(xh, gq[q]), bq[q]));
          }
        }
      }
    }
    CB_STAMP(1);
    // both blocks read their staged values before the barrier above
    cl_put_a<T, LD>(X, sT, pT, n0, ln);
    cl_arrive();
    cb_store_t<T>(X, A.hT + tab_off, n0, row0, A.M, A.Mp, ln);  // h_0 = zb
    cl_wait();
    CB_STAMP(2);
    // 2. rFF with TorchDense rounding; p_l in P
    const float* brff = A.brff + (size_t)run * A.L * HC;
    for (int l = 0; l < A.L; ++l) {
      if constexpr (BF)
        cl_product_bf16<HC, CB_KSB>(P, sA, ring, full, done, NWARPS, it, NST, ln, fill);
      else
        cl_product_f32<HC>(P, sA, ring, lobuf, full, it, NST, ln, fill, done, NWARPS);
      CB_STAMP(3);
      uint32_t pos = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + 8 * j + 2 * ln.t + (e & 1);
          const float p = round_to<T>(__fadd_rn(round_to<T>(P[j][e]), __ldg(brff + l * HC + col)));
          P[j][e] = p;
          if (p > 0.f) pos |= 1u << (j * 4 + e);
        }
      if (l == 0) pos0 = pos;
      posL = pos;
      if (l + 1 < A.L) {  // h_1 = relu(p_0), exact in T (p_0 lives on as pos0)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) P[j][e] = fmaxf(P[j][e], 0.f);
        cluster.sync();  // both blocks are done reading zb
        cl_put_a<T, LD>(P, sT, pT, n0, ln);
        cl_arrive();
        cb_store_t<T>(P, A.hT + tab_off + (size_t)(l + 1) * HC * A.Mp, n0, row0, A.M, A.Mp, ln);
        cl_wait();
        CB_STAMP(4);
      }
    }
    __syncthreads();  // this block is done with its A buffer: stage gy
    stage(A.gy + (size_t)run * HC + c * HALF, A.ldg, row0);
    // 3. out2 = zb + relu(p_L-1), LN1 -> xhat1 in X
    pa[0] = pa[1] = pb[0] = pb[1] = 0.f;
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
    CB_STAMP(5);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mu = pa[h] / HC;
      rs1[h] = rsqrtf(pb[h] / HC - mu * mu + EPS);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) X[j][2 * h + q] = __fmul_rn(__fsub_rn(X[j][2 * h + q], mu), rs1[h]);
    }
    // 4. upstream gradient (staged; the folded relu masks on the ROUNDED
    // output)
    wait_staged();
    {
      const float* b1 = A.b1 + (size_t)run * HC;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = h ? ok1 : ok0;
        const int r = ln.row(2 * h);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 + 8 * j + 2 * ln.t;
          const float2 gv = ok ? load2(sT + r * SW + col - c * HALF) : make_float2(0.f, 0.f);
          P[j][2 * h] = gv.x;
          P[j][2 * h + 1] = gv.y;
          if (A.relu) {
            const float2 g = ldg2(g1 + col), b = ldg2(b1 + col);
            const float gq[2] = {g.x, g.y}, bq[2] = {b.x, b.y};
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float y = round_to<T>(__fadd_rn(__fmul_rn(X[j][2 * h + q], gq[q]), bq[q]));
              if (!(y > 0.f)) P[j][2 * h + q] = 0.f;
            }
          }
        }
      }
    }
    // LN1 backward: P <- dz = dout2; X <- dp = dout2 * (p_L-1 > 0)
    pa[0] = pa[1] = pb[0] = pb[1] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float gg = P[j][e] * __ldg(g1 + n0 + 8 * j + 2 * ln.t + (e & 1));
        pa[e >> 1] += gg;
        pb[e >> 1] += gg * X[j][e];
      }
    cl_row_part<NWG>(pa, pb, red, blk, 2, ln);
    cb_col_add([&](int j, int e) { return P[j][e] * X[j][e]; }, part + 3 * HC, first, ln);
    cb_col_add([&](int j, int e) { return P[j][e]; }, part + 4 * HC, first, ln);
    cl_row_total(pa, pb, blk0, blk1, 2, ln);
    CB_STAMP(6);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float gg = P[j][e] * __ldg(g1 + n0 + 8 * j + 2 * ln.t + (e & 1));
        const float d = rs1[h] * (gg - pa[h] / HC - X[j][e] * (pb[h] / HC));
        P[j][e] = d;
        X[j][e] = (posL >> (j * 4 + e)) & 1 ? d : 0.f;
      }
    // 5. rFF backward, last layer first: X = dp_l; both blocks read their
    // staged gy before the barrier above
    for (int l = A.L - 1; l >= 0; --l) {
      if (l + 1 < A.L) cluster.sync();  // both blocks are done with dp_l+1's products
      cl_put_a<float, LD>(X, sF, pF, n0, ln);
      cl_arrive();
      cb_col_add([&](int j, int e) { return X[j][e]; }, part + (5 + l) * HC, first, ln);
      cb_store_t<float>(X, A.dpT + tab_off + (size_t)l * HC * A.Mp, n0, row0, A.M, A.Mp, ln);
      cl_wait();
      CB_STAMP(7);
      // dh = dp_l @ W_l^T
      cl_product_f32<HC>(X, sA, ring, lobuf, full, it, NST, ln, fill, done, NWARPS);
      CB_STAMP(8);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (l > 0) {
            if (!((pos0 >> (j * 4 + e)) & 1)) X[j][e] = 0.f;
          } else {
            P[j][e] += X[j][e];
          }
        }
    }
    if (first)
      for (int tb = 5 + A.L; tb < CB_TABS; ++tb)
        *reinterpret_cast<float2*>(part + tb * HC + 8 * ln.g + 2 * ln.t) = make_float2(0.f, 0.f);
    __syncthreads();  // this block is done with its A buffer: stage agg again
    stage(agg + c * HALF, A.lda, row0);
    // 6. LN0 backward (xhat0 recomputed into X) -> dout0 in P
    wait_staged();
    pa[0] = pa[1] = pb[0] = pb[1] = 0.f;
    {
      const float* seed = A.seed + (size_t)run * HC;
      cb_vals<T, HC>(sT, agg, A.lda, row0, ok0, ok1, n0, c, A.H, ln,
                     [&](int j, int e, int col, float v, float dinv) {
                       const int h = e >> 1;
                       const float x = __fadd_rn(__fmul_rn(v, dinv), __ldg(seed + col));
                       const float xh = __fmul_rn(__fsub_rn(x, mu0[h]), rs0[h]);
                       X[j][e] = xh;
                       const float gg = P[j][e] * __ldg(g0 + col);
                       pa[h] += gg;
                       pb[h] += gg * xh;
                     });
    }
    cl_row_part<NWG>(pa, pb, red, blk, 3, ln);
    cb_col_add([&](int j, int e) { return P[j][e] * X[j][e]; }, part + 1 * HC, first, ln);
    cb_col_add([&](int j, int e) { return P[j][e]; }, part + 2 * HC, first, ln);
    cl_row_total(pa, pb, blk0, blk1, 3, ln);
    CB_STAMP(9);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float gg = P[j][e] * __ldg(g0 + n0 + 8 * j + 2 * ln.t + (e & 1));
        P[j][e] = rs0[h] * (gg - pa[h] / HC - X[j][e] * (pb[h] / HC));
      }
    cb_col_add([&](int j, int e) { return P[j][e]; }, part, first, ln);  // dseed
    // 7. dagg: dvals = dout0 / max(den, floor) straight out; dout0 * vals
    // into the A buffer for the per-head dden sums
    cb_vals<T, HC>(sT, agg, A.lda, row0, ok0, ok1, n0, c, A.H, ln,
                   [&](int j, int e, int col, float v, float dinv) {
                     X[j][e] = P[j][e] * v;
                     P[j][e] = P[j][e] * dinv;
                   });
    T* dagg = A.dagg + (size_t)run * A.WP;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!(h ? ok1 : ok0)) continue;
      T* dr = dagg + (size_t)(row0 + ln.row(2 * h)) * A.lda;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store2(dr + n0 + 8 * j + 2 * ln.t, P[j][2 * h], P[j][2 * h + 1]);
    }
    __syncthreads();  // every warp is done with the staged values
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sF[ln.row(e) * SF + n0 - c * HALF + 8 * j + 2 * ln.t + (e & 1)] = X[j][e];
    __syncthreads();
    {
      // per (row, head) of the block's columns; the head across the halves
      // (if any) as the block's partial in ddx
      const int C = HC / A.H, hs = HALF / C;
      const bool straddle = HALF % C != 0;
      const int h_lo = (c * HALF) / C, nh = ((c + 1) * HALF - 1) / C - h_lo + 1;
      for (int i = threadIdx.x; i < CL_TM * nh; i += HC) {
        const int r = i / nh, hh = h_lo + i % nh, grow = row0 + r;
        const int cb = max(hh * C, c * HALF) - c * HALF, ce = min((hh + 1) * C, (c + 1) * HALF) - c * HALF;
        float sm = 0.f;
        for (int col = cb; col < ce; ++col) sm += sF[r * SF + col];
        if (straddle && hh == hs)
          ddx[r] = sm;
        else if (grow < A.M)
          dagg[(size_t)grow * A.lda + HC + hh] =
              from_f<T>(cb_dden(sm, to_f(agg[(size_t)grow * A.lda + HC + hh])));
      }
      if (straddle) {
        cluster.sync();  // both partials of the straddling head are in place
        const int grow = row0 + threadIdx.x;
        if (c == 0 && threadIdx.x < CL_TM && grow < A.M)
          dagg[(size_t)grow * A.lda + HC + hs] = from_f<T>(
              cb_dden(ddx[threadIdx.x] + ddx1[threadIdx.x], to_f(agg[(size_t)grow * A.lda + HC + hs])));
      }
      if (c == 0) {  // zeros in the pad columns
        const int NP = A.WP - HC - A.H;
        for (int i = threadIdx.x; i < CL_TM * NP; i += HC) {
          const int grow = row0 + i / NP;
          if (grow < A.M) dagg[(size_t)grow * A.lda + HC + A.H + i % NP] = from_f<T>(0.f);
        }
      }
    }
    __syncthreads();  // every warp is done with the sums: the next item's values
    if (k + 1 < my_items) {
      const int nx = w + ncl;
      stage(A.agg + (size_t)(nx / ntiles) * A.WP + c * HALF, A.lda, (nx % ntiles) * CL_TM);
    }
    CB_STAMP(10);
#ifdef CB_PHASES
    if (threadIdx.x == 0) cb_acc[11] += 1;
#endif
  }
  cluster.sync();  // the peer may still read this block's shared memory
#ifdef CB_PHASES
  if (threadIdx.x == 0)
    for (int i = 0; i < 12; ++i) atomicAdd(&cb_total[i], (unsigned long long)cb_acc[i]);
#endif
}

template <typename T, int HC>
int launch_bwd_cluster(const CbArgs<T>& A, int R, float* dW, float* dsmall, float* part_w,
                       int nch, int chunk_rows, int parts, cudaStream_t s) {
  cudaError_t e;
  if (parts & 1) {
    const CbLayout S = cb_layout(HC);
    if (S.nst < 2) return (int)cudaErrorInvalidValue;  // a ring of 2 slots at least
    const int ntiles = (A.M + CL_TM - 1) / CL_TM;
    // the partials the caller sized: one entry per cluster
    if (A.NE != (ntiles < CB_ENTRIES ? ntiles : CB_ENTRIES)) return (int)cudaErrorInvalidValue;
    void (*kern)(CbArgs<T>, int) = pma_bwd_cluster_kernel<T, HC>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S.bytes);
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
    // NE clusters (the H100 holds 66 at once; a card with fewer runs the
    // rest as they free up: no cluster waits for another)
    cfg.gridDim = dim3(2 * (unsigned)A.NE, 1, 1);
    e = cudaLaunchKernelEx(&cfg, kern, A, R);
    if (e != cudaSuccess) return (int)e;
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (parts & 2) {
    using D = DwgPlan<T, HC>;
    e = cudaFuncSetAttribute(dw_wg_kernel<T, HC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             D::bytes);
    if (e != cudaSuccess) return (int)e;
    dw_wg_kernel<T, HC><<<(unsigned)R * nch * A.L * (HC / D::BJ) * (HC / D::BN), 128 * D::NWG,
                          D::bytes, s>>>(A.hT, A.dpT, A.Mp, A.L, nch, chunk_rows, part_w);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (parts & 4) {
    e = launch_reduce(part_w, nch, A.L * HC * HC, dW, A.part_small, 4 * A.NE, CB_TABS * HC,
                      dsmall, R, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3/K3R at HC 384 and 512. Inputs as allset_pma_epilogue_bwd's, with the
// weights as the column halves' slabs of ops/cuda_pma.py::
// cluster_bwd_weights (wf: forward, wb: backward). Scratch (allocated by
// the caller), per run: hT [R, L, HC, Mp] dtype, dpT [R, L, HC, Mp] f32,
// part_small [R, 4 NE, 8, HC] f32 (NE = min(tiles of 64 rows, 66)),
// part_w [R, nch, L, HC, HC] f32. parts: K3a (1), K3b (2), K3c (4).
// Returns 1 (cudaErrorInvalidValue) for another HC or NE, and the launch's
// error where no cluster of two blocks can be resident.
int allset_pma_epilogue_bwd_cluster(const void* agg, const void* gy, const void* seed,
                                    const void* g0, const void* b0, const void* wf,
                                    const void* wb, const void* brff, const void* g1,
                                    const void* b1, void* dagg, void* dW, void* dsmall, void* hT,
                                    void* dpT, void* part_small, void* part_w, int M, int Mp,
                                    int WP, int HC, int H, int L, int R, int relu, int dtype,
                                    int NE, int nch, int chunk_rows, int parts, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || R <= 0) return (int)cudaGetLastError();
#define BWD_CL(T, HCV)                                                                      \
  if (HC == HCV) {                                                                          \
    CbArgs<T> A;                                                                            \
    A.agg = static_cast<const T*>(agg);                                                     \
    A.gy = static_cast<const T*>(gy);                                                       \
    A.seed = static_cast<const float*>(seed);                                               \
    A.g0 = static_cast<const float*>(g0);                                                   \
    A.b0 = static_cast<const float*>(b0);                                                   \
    A.brff = static_cast<const float*>(brff);                                               \
    A.g1 = static_cast<const float*>(g1);                                                   \
    A.b1 = static_cast<const float*>(b1);                                                   \
    A.wf = static_cast<const char*>(wf);                                                    \
    A.wb = static_cast<const char*>(wb);                                                    \
    A.dagg = static_cast<T*>(dagg);                                                         \
    A.hT = static_cast<T*>(hT);                                                             \
    A.dpT = static_cast<float*>(dpT);                                                       \
    A.part_small = static_cast<float*>(part_small);                                         \
    A.M = M, A.Mp = Mp, A.H = H, A.L = L, A.WP = WP, A.relu = relu, A.NE = NE;              \
    A.lda = (size_t)R * WP;                                                                 \
    A.ldg = (size_t)R * HC;                                                                 \
    return launch_bwd_cluster<T, HCV>(A, R, static_cast<float*>(dW),                        \
                                      static_cast<float*>(dsmall), static_cast<float*>(part_w), \
                                      nch, chunk_rows, parts, s);                           \
  }
  if (dtype == 0) {
    BWD_CL(float, 384) BWD_CL(float, 512)
  } else {
    BWD_CL(__nv_bfloat16, 384) BWD_CL(__nv_bfloat16, 512)
  }
#undef BWD_CL
  return (int)cudaErrorInvalidValue;
}

#ifdef CB_PHASES
// the phases' clocks summed over the blocks' thread 0 (zero: reset them)
int allset_cb_phases(void* out, int zero) {
  if (zero) {
    unsigned long long z[12] = {};
    return (int)cudaMemcpyToSymbol(cb_total, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, cb_total, sizeof(cb_total));
}
#endif

}  // extern "C"
