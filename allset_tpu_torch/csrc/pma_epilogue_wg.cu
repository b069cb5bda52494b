// K3 / K3R at HC 256 on Hopper's warpgroup products: the fused PMA
// epilogue's backward (pallas_pma.py::_bwd_kernel, its R = 1 and R > 1
// grids); the contract and the forward chain are those of
// pma_epilogue.cuh, whose K3 serves the other widths up to 512. K2 / K2R
// in f32 at HC 256 (pallas_pma.py::_fwd_kernel) runs K3a's forward on the
// same layout, below K3a. (K3a's
// tile plan takes any multiple of 64 up to 256, but at 64, 128 and 192
// the 16-warp K3 was faster in alternating pairs, scripts/k3_parts.py; at
// 384 and 512 a warpgroup of 64 columns would need more registers than
// the 85 a thread of a 768- or 1024-thread block may have: K2 there runs
// on a cluster of two blocks, each half the columns, in
// pma_epilogue_cluster.cu, which shares this file's primitives through
// pma_wgmma.cuh.)
//
// What bounds it on the H100: the rFF products, four per row in the row
// pass at L = 2 (two forward, two dp @ W^T) and two more for dW (h^T dp),
// and the weights, which do not fit beside a tile from HC 256 and stream
// from L2 once per tile. The design:
//   * K3a, persistent (one block per SM over the row tiles of its run): a
//     64-row tile per iteration, HC / 64 warpgroups that each own 64
//     columns (a [64, 64] share of every intermediate in registers, in the
//     wgmma accumulator layout: 32 floats a thread per intermediate; 128
//     registers a thread, where two warpgroups of 128 columns were
//     slower). Thread 0 starts a ring of up to NST slots in shared
//     memory with the tile's first weight slabs, one bulk copy
//     (cp.async.bulk, the TMA's linear mode) per half slab completing on
//     the slot's mbarrier; after that the last warp done with a slot
//     refills it with the slab NST further on, in the order the products
//     take them (forward l = 0..L-1, then backward l = L-1..0, tile after
//     tile). The slabs are laid out by the wrapper in the operand layout
//     wgmma reads (K-major 8 x 16-byte core matrices), the f32 weights
//     already split into TF32 hi and lo parts;
//   * every product is a wgmma with A from registers: the A operand (zb,
//     round(relu(p0)) or dp, all HC columns) sits in shared memory once
//     per product, written by all warpgroups and read back a slab at a
//     time as wgmma fragments. bf16 operands use m64n64k16 bf16; the
//     products the JAX package takes in f32 use 3xTF32 on m64n64k8 tf32
//     (a*b ~ al*bh + ah*bl + ah*bh, the error argument of
//     pma_epilogue.cuh), A split in registers per slab, B split by the
//     wrapper once per launch;
//   * the tile's agg rows (twice: for LN0 and for its backward and dagg)
//     and gy rows come into the A operand's buffer by bulk copies (warp
//     0, one per row) whenever it is free, the first for the next tile
//     at the end of the current one; the next tile's rows are prefetched
//     into L2 at its start. Every head count dividing HC runs; where the
//     staged rows would not fit beside a ring of 4 slots the ring takes 3
//     or 2;
//   * row statistics cross the warpgroups through shared memory, added in
//     a fixed order (the t lanes by a shuffle tree, then the warpgroups in
//     order), in two alternating buffers (one barrier per exchange); the
//     small-vector gradients are column sums, each warp's over its 16 rows
//     added into its own table, the block's partial the four tables of
//     each warpgroup in order;
//   * K3a writes the rFF inputs h_l and output gradients dp_l transposed,
//     [L, HC, Mp] (Mp = M rounded up to 8 rows, zeros past M), so that
//     K3b reads both with the row index contiguous (K-major);
//   * K3b: dW partials over 64 fixed row chunks as dW^T = dp^T h, a 64 x
//     BN tile per warpgroup, two blocks an SM: A = dp from registers
//     (16-row fragments of the staged chunk), B = h through a descriptor,
//     three cp.async stages. bf16 h: dp = d1 + d2 + d3, three bf16 parts
//     (exact: 8 + 8 + 8 significant bits), three bf16 products, each
//     exact in the f32 accumulator's inputs; f32 h: 3xTF32, h split into
//     its TF32 hi and lo parts in shared memory once per stage;
//   * K3c (pma_epilogue.cuh): one launch, the fixed-order reduce of both
//     partial tables. No floating-point atomics (the one atomic counts the
//     warps done with a ring slot), so two calls give the same bits, and
//     run r of K3R equals a K3 launch on run r's slice bit for bit (same
//     tiles, blocks and partials; the runs are the second grid axis).

#include "pma_wgmma.cuh"

namespace {

constexpr int WG_TM = 64;                       // rows per tile
constexpr int WG_N = 64;                        // columns per warpgroup
constexpr int WG_TABS = 7;                      // small-vector sums kept (5 + L)

template <typename T>
struct WgArgs {
  const T* agg;
  const T* gy;
  const float *seed, *g0, *b0, *brff, *g1, *b1;
  const char* wf;     // forward slabs [L][HC / KS][wg_slot]: W^T, bf16 or f32 hi|lo
  const char* wb;     // backward slabs [L][HC / KSF][wg_slot]: W, f32 hi|lo
  T* dagg;
  T* hT;              // [L][HC][Mp] rFF inputs
  float* dpT;         // [L][HC][Mp] rFF output gradients
  float* part_small;  // [gridDim.x][8][HC]
  int M, Mp, H, L, WP, relu;
  size_t lda, ldg;
};

template <typename T, int HC>
__device__ __forceinline__ WgArgs<T> wg_at_run(WgArgs<T> A, int run) {
  constexpr size_t slot = wg_slot(HC);
  A.agg += (size_t)run * A.WP, A.dagg += (size_t)run * A.WP, A.gy += (size_t)run * HC;
  A.seed += (size_t)run * HC, A.g0 += (size_t)run * HC, A.b0 += (size_t)run * HC;
  A.g1 += (size_t)run * HC, A.b1 += (size_t)run * HC, A.brff += (size_t)run * A.L * HC;
  A.wf += (size_t)run * A.L * (HC / wg_ksf<T>()) * slot;
  A.wb += (size_t)run * A.L * (HC / WG_KSF) * slot;
  const size_t per = (size_t)A.L * HC * A.Mp;
  A.hT += run * per, A.dpT += run * per;
  A.part_small += (size_t)run * gridDim.x * 8 * HC;
  return A;
}

// --- K3a ------------------------------------------------------------------------

// K3a's shared memory: the ring of nst slots, the stage (the A operand
// [64][HC + 4] f32 or [64][HC + 8] bf16, in turn the tile's agg rows
// [64][WP] and gy rows [64][HC] in T), the warps' column tables, the row
// exchange [2 buffers][HC / 64 warpgroups][2][64], the mbarriers (each
// slot's, the stage's) and the slots' done counts. The ring takes what
// the rest leaves, at most WG_NST slots.
struct WgLayout {
  size_t a, tab, red, bar, args, bytes;
  int nst;
};
constexpr size_t WG_ARGS_BYTES = 256;  // the block's run's arguments (WgArgs)
__host__ __device__ inline WgLayout wg_layout(int HC, int WP, int item) {
  size_t stage = (size_t)WG_TM * (HC + 4) * 4;
  if ((size_t)WG_TM * WP * item > stage) stage = (size_t)WG_TM * WP * item;
  stage = (stage + 127) / 128 * 128;
  // the tables: 4 NWG warps x WG_TABS sums x HC / NWG columns, 4 bytes
  const size_t rest = stage + (size_t)16 * HC * WG_TABS +
                      2 * (size_t)(HC / WG_N) * 2 * WG_TM * 4 + (2 * WG_NST + 2) * 8 +
                      WG_ARGS_BYTES;
  WgLayout L;
  const size_t room = SMEM_MAX > rest ? (SMEM_MAX - rest) / wg_slot(HC) : 0;
  L.nst = room < WG_NST ? (int)room : WG_NST;
  L.a = (size_t)L.nst * wg_slot(HC);
  L.tab = L.a + stage;
  L.red = L.tab + (size_t)16 * HC * WG_TABS;
  L.bar = L.red + 2 * (size_t)(HC / WG_N) * 2 * WG_TM * 4;
  L.args = L.bar + (2 * L.nst + 2) * 8;
  L.bytes = L.args + WG_ARGS_BYTES;
  return L;
}

// Rows [row0, row0 + 64) of src (row stride ld, cols elements each, 16-byte
// rows) into dst as [64][cols], by warp 0 with one bulk copy a row,
// completing on bar; rows past M are not copied.
template <typename T>
__device__ __forceinline__ void wg_stage_rows(T* dst, const T* src, size_t ld, int cols,
                                              int row0, int M, uint64_t* bar) {
  const int lane = threadIdx.x & 31, nvalid = min(WG_TM, M - row0);
  const uint32_t bytes = cols * sizeof(T);
  if (lane == 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, nvalid * bytes);
  }
  __syncwarp();
  for (int r = lane; r < nvalid; r += 32)
    bulk_load(dst + (size_t)r * cols, src + (size_t)(row0 + r) * ld, bytes, bar);
}

// Row totals of two per-element quantities over all HC columns: pa[h],
// pb[h] hold the thread's partial sums for its rows (h = 0: row(0), 1:
// row(2)); on return, the totals: the t lanes by a shuffle tree, then the
// NWG warpgroups' partials in order, through one of two buffers.
template <int NWG>
__device__ __forceinline__ void wg_row_sum(float (&pa)[2], float (&pb)[2], float* red, int& buf,
                                           const WgLane& ln) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pa[h] += __shfl_xor_sync(0xffffffffu, pa[h], 1);
    pa[h] += __shfl_xor_sync(0xffffffffu, pa[h], 2);
    pb[h] += __shfl_xor_sync(0xffffffffu, pb[h], 1);
    pb[h] += __shfl_xor_sync(0xffffffffu, pb[h], 2);
  }
  float* r = red + buf * NWG * 2 * WG_TM;  // [NWG warpgroups][2][64]
  if (ln.t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      r[(ln.q * 2 + 0) * WG_TM + ln.row(2 * h)] = pa[h];
      r[(ln.q * 2 + 1) * WG_TM + ln.row(2 * h)] = pb[h];
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = ln.row(2 * h);
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int q = 0; q < NWG; ++q) {
      sa += r[(q * 2 + 0) * WG_TM + rr];
      sb += r[(q * 2 + 1) * WG_TM + rr];
    }
    pa[h] = sa, pb[h] = sb;
  }
  buf ^= 1;
}

// tab[c] += the sum over the warp's 16 rows of f(j, e), for each of the
// warp's columns c (8 j + 2 t + e % 2 of its warpgroup): the thread's two
// rows, then a shuffle tree over g; the lane with g == 0 owns the column.
template <int NT, typename F>
__device__ __forceinline__ void wg_col_add(F f, float* tab, const WgLane& ln) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float s = f(j, q) + f(j, q + 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (ln.g == 0) tab[8 * j + 2 * ln.t + q] += s;
    }
}

// The warpgroup's share of the next product's A operand into shared
// memory (T values in [64][HC + 8], f32 in [64][HC + 4]).
template <typename T, int HC, int NT>
__device__ __forceinline__ void wg_put_a(const float (&x)[NT][4], char* sA, const WgLane& ln) {
  constexpr int LD = sizeof(T) == 4 ? HC + 4 : HC + 8;
  T* s = reinterpret_cast<T*>(sA);
  const int n0 = ln.q * 8 * NT;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store2(s + ln.row(2 * h) * LD + n0 + 8 * j + 2 * ln.t, x[j][2 * h], x[j][2 * h + 1]);
}

// Tile rows of an [HC][Mp] transposed table (rows past M as zeros, none
// past Mp).
template <typename T, int HC, int NT>
__device__ __forceinline__ void wg_store_t(const float (&x)[NT][4], T* dst, int row0, int M,
                                           int Mp, const WgLane& ln) {
  const int n0 = ln.q * 8 * NT;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int grow = row0 + ln.row(2 * h);
    if (grow >= Mp) continue;
    const bool ok = grow < M;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        dst[(size_t)(n0 + 8 * j + 2 * ln.t + q) * Mp + grow] =
            from_f<T>(ok ? x[j][2 * h + q] : 0.f);
  }
}

// acc = A @ B over one product's HC / KS slabs from the ring: A [64][HC]
// in shared memory (bf16 [64][HC + 8] with BF, else f32 [64][HC + 4]), the
// slabs in order from slot it % nst. Per slab the warpgroup loads its A
// fragments (3xTF32: split into hi and lo), waits for the slab, runs its
// products and waits for them (double-buffered fragments spilled at 128
// registers and were slower); then each warp counts itself done with the
// slot (done[slot]), and the last of the block's nwarps refills the slot
// with slab it + s + nst (fill).
template <int HC, int NT, bool BF, typename Fill>
__device__ __forceinline__ void wg_product(float (&acc)[NT][4], const char* sA, const char* ring,
                                           uint64_t* full, uint32_t* done, uint32_t nwarps,
                                           uint32_t& it, uint32_t nst, const WgLane& ln,
                                           Fill& fill) {
  constexpr int KS = BF ? WG_KSB : WG_KSF, NS = HC / KS, KK = BF ? KS / 16 : KS / 8;
  constexpr uint32_t LBO = HC * 16, SLOT = wg_slot(HC);
  const uint32_t n_off = ln.q * NT * 128;  // the warpgroup's first n-group of core matrices
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  fence_acc(acc);
#pragma unroll 1
  for (int s = 0; s < NS; ++s) {
    uint32_t ah[KK][4], al[KK][4];
    wg_a_frags<HC, BF>(sA, s, ln, ah, al);
    const uint32_t n = it + s, slot = n % nst;
    mbar_wait(&full[slot], (n / nst) & 1);
    __syncwarp();
    wg_fence();
    const uint32_t base = smem_u32(ring + slot * SLOT) + n_off;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint64_t dh = desc_k(base + 2 * kk * LBO, LBO, 128);
      if constexpr (BF) {
        wgmma_bf16(acc, ah[kk], dh);
      } else {
        const uint64_t dl = desc_k(base + SLOT / 2 + 2 * kk * LBO, LBO, 128);
        wgmma_tf32(acc, al[kk], dh);
        wgmma_tf32(acc, ah[kk], dl);
        wgmma_tf32(acc, ah[kk], dh);
      }
    }
    wg_commit();
    wg_wait<0>();
    __syncwarp();
    if ((threadIdx.x & 31) == 0 && atomicAdd(&done[slot], 1u) + 1 == (n / nst + 1) * nwarps)
      fill(n + nst);
    __syncwarp();
  }
  fence_acc(acc);
  it += NS;
}

// out0 = vals / max(den, floor) + seed at tile row r, column c, from the
// staged agg rows st [64][WP] (0 past M: the row of an empty segment)
template <typename T, int HC>
__device__ __forceinline__ float wg_out0(const T* st, int WP, int r, bool ok, int c, float invC,
                                         const float* seed, float& v, float& dinv) {
  v = ok ? to_f(st[r * WP + c]) : 0.f;
  // head c / C (C = HC / H columns a head) by a reciprocal: exact for c < 2^12
  const float den = ok ? to_f(st[r * WP + HC + (int)((c + 0.5f) * invC)]) : 0.f;
  dinv = __frcp_rn(fmaxf(den, DEN_FLOOR));
  return __fadd_rn(__fmul_rn(v, dinv), __ldg(seed + c));
}

template <typename T, int HC, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1) pma_bwd_wg_kernel(WgArgs<T> A0) {
  constexpr int WN = HC / NWG, NT = WN / 8, NTH = 128 * NWG;
  constexpr bool BF = sizeof(T) == 2;
  constexpr int NSF = HC / wg_ksf<T>(), NSB = HC / WG_KSF;
  constexpr uint32_t SLOT = wg_slot(HC);
  extern __shared__ __align__(128) char smem[];
  static_assert(sizeof(WgArgs<T>) <= WG_ARGS_BYTES, "the arguments' room");
  const WgLayout S = wg_layout(HC, A0.WP, sizeof(T));
  // the run's arguments live in shared memory and are read where used, so
  // that they do not hold registers (128 a thread at HC 256)
  WgArgs<T>* sargs = reinterpret_cast<WgArgs<T>*>(smem + S.args);
  if (threadIdx.x == 0) *sargs = wg_at_run<T, HC>(A0, blockIdx.y);
  const WgArgs<T>& A = *sargs;
  const uint32_t NST = S.nst;
  char* ring = smem;
  char* sA = smem + S.a;
  const T* st = reinterpret_cast<const T*>(sA);  // staged agg or gy rows
  float* tab0 = reinterpret_cast<float*>(smem + S.tab);
  float* red = reinterpret_cast<float*>(smem + S.red);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S.bar);
  uint64_t* staged = full + NST;
  uint32_t* done = reinterpret_cast<uint32_t*>(staged + 1);  // warps done with each slot
  for (int i = threadIdx.x; i < 4 * NWG * WG_TABS * WN; i += NTH) tab0[i] = 0.f;
  if (threadIdx.x == 0) {
    for (uint32_t i = 0; i < NST; ++i) {
      mbar_init(&full[i], 1);
      done[i] = 0;
    }
    mbar_init(staged, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ntiles = (A.M + WG_TM - 1) / WG_TM;
  // slab n of the block's sequence (per tile: the forward products' slabs,
  // l = 0..L-1, then the backward's, l = L-1..0) into slot n % NST, by
  // thread 0 for the first NST, then by the last warp done with the slot
  const int my_tiles = blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const uint32_t nseq = A.L * (NSF + NSB), total = my_tiles * nseq;
  auto fill = [&](uint32_t n) {
    if (n >= total) return;
    const uint32_t slot = n % NST, w = n % nseq;
    const char* src;
    if (w < A.L * NSF) {
      src = A.wf + (size_t)w * SLOT;
    } else {
      const uint32_t w2 = w - A.L * NSF;
      src = A.wb + ((size_t)(A.L - 1 - w2 / NSB) * NSB + w2 % NSB) * SLOT;
    }
    mbar_expect_tx(&full[slot], SLOT);
    bulk_load(ring + slot * SLOT, src, SLOT / 2, &full[slot]);
    bulk_load(ring + slot * SLOT + SLOT / 2, src + SLOT / 2, SLOT / 2, &full[slot]);
  };
  if (threadIdx.x == 0)
    for (uint32_t n = 0; n < NST; ++n) fill(n);
  // the stage's uses alternate the parity of its barrier
  uint32_t nstaged = 0;
  auto wait_staged = [&]() {
    mbar_wait(staged, nstaged & 1);
    ++nstaged;
  };
  if (threadIdx.x < 32 && blockIdx.x < ntiles)
    wg_stage_rows(reinterpret_cast<T*>(sA), A.agg, A.lda, A.WP, blockIdx.x * WG_TM, A.M, staged);
  const WgLane ln;
  const int n0 = ln.q * WN;
  const float invC = (float)A.H / HC;
  float* tab = tab0 + (ln.q * 4 + ln.w) * WG_TABS * WN;
  int buf = 0;
  uint32_t it = 0;
  float X[NT][4], P[NT][4];
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * WG_TM;
    if (threadIdx.x < 32) {  // warp 0: the block's next tile's rows into L2
      const int next = tile + gridDim.x;
      for (int r = threadIdx.x; r < WG_TM && next < ntiles; r += 32) {
        const int grow = next * WG_TM + r;
        if (grow >= A.M) break;
        prefetch_l2(A.agg + (size_t)grow * A.lda, A.WP * sizeof(T));
        prefetch_l2(A.gy + (size_t)grow * A.ldg, HC * sizeof(T));
      }
    }
    const bool ok0 = row0 + ln.row(0) < A.M, ok1 = row0 + ln.row(2) < A.M;
    float pa[2] = {0.f, 0.f}, pb[2] = {0.f, 0.f}, mu0[2], rs0[2], rs1[2];
    // 1. out0 (the tile's agg rows, staged) and LN0 -> zb (in X)
    wait_staged();
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v, dinv;
        const float x = wg_out0<T, HC>(st, A.WP, ln.row(e), e < 2 ? ok0 : ok1,
                                       n0 + 8 * j + 2 * ln.t + (e & 1), invC, A.seed, v, dinv);
        X[j][e] = x;
        pa[e >> 1] += x;
        pb[e >> 1] += x * x;
      }
    wg_row_sum<NWG>(pa, pb, red, buf, ln);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mu0[h] = pa[h] / HC;
      rs0[h] = rsqrtf(pb[h] / HC - mu0[h] * mu0[h] + EPS);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n0 + 8 * j + 2 * ln.t + (e & 1), h = e >> 1;
        const float xh = __fmul_rn(__fsub_rn(X[j][e], mu0[h]), rs0[h]);
        X[j][e] = round_to<T>(__fadd_rn(__fmul_rn(xh, __ldg(A.g0 + c)), __ldg(A.b0 + c)));
      }
    wg_store_t<T, HC, NT>(X, A.hT, row0, A.M, A.Mp, ln);  // h_0 = zb
    __syncthreads();  // every warp is done with the staged rows
    wg_put_a<T, HC, NT>(X, sA, ln);
    __syncthreads();
    // 2. rFF with TorchDense rounding; p_l in P
    uint64_t pos0 = 0, posL = 0;
    for (int l = 0; l < A.L; ++l) {
      wg_product<HC, NT, BF>(P, sA, ring, full, done, 4 * NWG, it, NST, ln, fill);
      uint64_t pos = 0;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n0 + 8 * j + 2 * ln.t + (e & 1);
          const float p =
              round_to<T>(__fadd_rn(round_to<T>(P[j][e]), __ldg(A.brff + l * HC + c)));
          P[j][e] = p;
          if (p > 0.f) pos |= 1ull << (j * 4 + e);
        }
      if (l == 0) pos0 = pos;
      posL = pos;
      if (l + 1 < A.L) {  // h_1 = relu(p_0), exact in T (p_0 lives on as pos0)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) P[j][e] = fmaxf(P[j][e], 0.f);
        wg_store_t<T, HC, NT>(P, A.hT + (size_t)(l + 1) * HC * A.Mp, row0, A.M, A.Mp, ln);
        __syncthreads();  // every warp is done reading zb
        wg_put_a<T, HC, NT>(P, sA, ln);
        __syncthreads();
      }
    }
    __syncthreads();  // every warp is done with the last A operand: stage gy
    if (threadIdx.x < 32)
      wg_stage_rows(reinterpret_cast<T*>(sA), A.gy, A.ldg, HC, row0, A.M, staged);
    // 3. out2 = zb + relu(p_L-1), LN1 -> xhat1 in X
    pa[0] = pa[1] = pb[0] = pb[1] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float o = __fadd_rn(X[j][e], fmaxf(P[j][e], 0.f));
        X[j][e] = o;
        pa[e >> 1] += o;
        pb[e >> 1] += o * o;
      }
    wg_row_sum<NWG>(pa, pb, red, buf, ln);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mu = pa[h] / HC;
      rs1[h] = rsqrtf(pb[h] / HC - mu * mu + EPS);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          X[j][2 * h + q] = __fmul_rn(__fsub_rn(X[j][2 * h + q], mu), rs1[h]);
    }
    // 4. upstream gradient (staged; the folded relu masks on the ROUNDED
    // output)
    wait_staged();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = h ? ok1 : ok0;
      const int r = ln.row(2 * h);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = n0 + 8 * j + 2 * ln.t;
        const float2 gv = ok ? load2(st + r * HC + c) : make_float2(0.f, 0.f);
        P[j][2 * h] = gv.x;
        P[j][2 * h + 1] = gv.y;
        if (A.relu) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float y = round_to<T>(
                __fadd_rn(__fmul_rn(X[j][2 * h + q], __ldg(A.g1 + c + q)), __ldg(A.b1 + c + q)));
            if (!(y > 0.f)) P[j][2 * h + q] = 0.f;
          }
        }
      }
    }
    wg_col_add<NT>([&](int j, int e) { return P[j][e] * X[j][e]; }, tab + 3 * WN, ln);
    wg_col_add<NT>([&](int j, int e) { return P[j][e]; }, tab + 4 * WN, ln);
    // LN1 backward: P <- dz = dout2; X <- dp = dout2 * (p_L-1 > 0)
    pa[0] = pa[1] = pb[0] = pb[1] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float gg = P[j][e] * __ldg(A.g1 + n0 + 8 * j + 2 * ln.t + (e & 1));
        pa[e >> 1] += gg;
        pb[e >> 1] += gg * X[j][e];
      }
    wg_row_sum<NWG>(pa, pb, red, buf, ln);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float gg = P[j][e] * __ldg(A.g1 + n0 + 8 * j + 2 * ln.t + (e & 1));
        const float d = rs1[h] * (gg - pa[h] / HC - X[j][e] * (pb[h] / HC));
        P[j][e] = d;
        X[j][e] = (posL >> (j * 4 + e)) & 1 ? d : 0.f;
      }
    // 5. rFF backward, last layer first: X = dp_l
    for (int l = A.L - 1; l >= 0; --l) {
      wg_col_add<NT>([&](int j, int e) { return X[j][e]; }, tab + (5 + l) * WN, ln);
      wg_store_t<float, HC, NT>(X, A.dpT + (size_t)l * HC * A.Mp, row0, A.M, A.Mp, ln);
      __syncthreads();  // every warp is done with the staged gy or the last A operand
      wg_put_a<float, HC, NT>(X, sA, ln);
      __syncthreads();
      // dh = dp_l @ W_l^T
      wg_product<HC, NT, false>(X, sA, ring, full, done, 4 * NWG, it, NST, ln, fill);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (l > 0) {
            if (!((pos0 >> (j * 4 + e)) & 1)) X[j][e] = 0.f;
          } else {
            P[j][e] += X[j][e];
          }
        }
    }
    __syncthreads();  // every warp is done with the last A operand: stage agg again
    if (threadIdx.x < 32)
      wg_stage_rows(reinterpret_cast<T*>(sA), A.agg, A.lda, A.WP, row0, A.M, staged);
    // 6. LN0 backward (xhat0 recomputed into X) -> dout0 in P
    wait_staged();
    pa[0] = pa[1] = pb[0] = pb[1] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n0 + 8 * j + 2 * ln.t + (e & 1), h = e >> 1;
        float v, dinv;
        const float x =
            wg_out0<T, HC>(st, A.WP, ln.row(e), h ? ok1 : ok0, c, invC, A.seed, v, dinv);
        const float xh = __fmul_rn(__fsub_rn(x, mu0[h]), rs0[h]);
        X[j][e] = xh;
        const float gg = P[j][e] * __ldg(A.g0 + c);
        pa[h] += gg;
        pb[h] += gg * xh;
      }
    wg_col_add<NT>([&](int j, int e) { return P[j][e] * X[j][e]; }, tab + 1 * WN, ln);
    wg_col_add<NT>([&](int j, int e) { return P[j][e]; }, tab + 2 * WN, ln);
    wg_row_sum<NWG>(pa, pb, red, buf, ln);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float gg = P[j][e] * __ldg(A.g0 + n0 + 8 * j + 2 * ln.t + (e & 1));
        P[j][e] = rs0[h] * (gg - pa[h] / HC - X[j][e] * (pb[h] / HC));
      }
    wg_col_add<NT>([&](int j, int e) { return P[j][e]; }, tab, ln);  // dseed
    // 7. dagg: dvals straight out (vals kept in X); then dout0 * vals into
    // the stage for the per-head dden sums, dden and zeros in the pad
    // columns; then the next tile's agg rows into the stage
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = h ? ok1 : ok0;
      const int r = ln.row(2 * h), grow = row0 + r;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = n0 + 8 * j + 2 * ln.t;
        float d[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float dinv;
          wg_out0<T, HC>(st, A.WP, r, ok, c + q, invC, A.seed, X[j][2 * h + q], dinv);
          d[q] = P[j][2 * h + q] * dinv;
        }
        if (ok) store2(A.dagg + (size_t)grow * A.lda + c, d[0], d[1]);
      }
    }
    __syncthreads();  // every warp is done with the staged agg rows
    float* sf = reinterpret_cast<float*>(sA);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sf[ln.row(e) * (HC + 4) + n0 + 8 * j + 2 * ln.t + (e & 1)] = P[j][e] * X[j][e];
    __syncthreads();
    const int NP = A.WP - HC, C = HC / A.H;
    for (int i = threadIdx.x; i < WG_TM * NP; i += NTH) {  // per (row, head or pad)
      const int r = i / NP, hh = i % NP, grow = row0 + r;
      if (grow >= A.M) continue;
      float dd = 0.f;
      if (hh < A.H) {
        float sm = 0.f;
        for (int c = hh * C; c < (hh + 1) * C; ++c) sm += sf[r * (HC + 4) + c];
        const float den = to_f(A.agg[(size_t)grow * A.lda + HC + hh]);
        const float dinv = 1.f / fmaxf(den, DEN_FLOOR);
        dd = den > DEN_FLOOR ? -sm * (dinv * dinv) : 0.f;
      }
      A.dagg[(size_t)grow * A.lda + HC + hh] = from_f<T>(dd);
    }
    __syncthreads();  // every warp is done with the sums: stage the next tile's agg
    if (threadIdx.x < 32 && tile + (int)gridDim.x < ntiles)
      wg_stage_rows(reinterpret_cast<T*>(sA), A.agg, A.lda, A.WP,
                    (tile + (int)gridDim.x) * WG_TM, A.M, staged);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * HC; i += NTH) {  // the warps' tables in order
    const int k = i / HC, c = i % HC, q = c / WN, cl = c % WN;
    float v = 0.f;
    if (k < WG_TABS)
      for (int w = 0; w < 4; ++w) v += tab0[((q * 4 + w) * WG_TABS + k) * WN + cl];
    A.part_small[(size_t)blockIdx.x * 8 * HC + i] = v;
  }
}

// --- K2 / K2R ------------------------------------------------------------------
//
// The forward on K3a's layout: a persistent block per SM walks the (run,
// tile) items (item w: run w / ntiles, tile w % ntiles), HC / 64
// warpgroups of 64 columns each over a 64-row tile, the forward slabs
// through the same ring (thread 0 fills the first NST, then the last warp
// done with a slot), the tile's agg rows staged by bulk copies into the A
// operand's buffer, zb kept in registers for the residual. Once the last
// product is done with the buffer the next item's rows come into it, while
// LN1 runs and y leaves from registers. Every item is computed alike
// whatever block takes it, so run r of K2R equals a K2 launch on run r's
// slice bit for bit.
template <typename T, int HC, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1) pma_fwd_wg_kernel(WgArgs<T> A, int R) {
  constexpr int WN = HC / NWG, NT = WN / 8;
  constexpr bool BF = sizeof(T) == 2;
  constexpr int NSF = HC / wg_ksf<T>();
  constexpr uint32_t SLOT = wg_slot(HC);
  extern __shared__ __align__(128) char smem[];
  const WgLayout S = wg_layout(HC, A.WP, sizeof(T));
  const uint32_t NST = S.nst;
  char* ring = smem;
  char* sA = smem + S.a;
  T* st = reinterpret_cast<T*>(sA);  // staged agg rows
  float* red = reinterpret_cast<float*>(smem + S.red);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S.bar);
  uint64_t* staged = full + NST;
  uint32_t* done = reinterpret_cast<uint32_t*>(staged + 1);
  const int ntiles = (A.M + WG_TM - 1) / WG_TM, nwork = R * ntiles;
  const int my_items =
      (int)blockIdx.x < nwork ? (nwork - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const uint32_t nseq = A.L * NSF, total = my_items * nseq;
  auto fill = [&](uint32_t n) {  // slab n of the block's sequence into slot n % NST
    if (n >= total) return;
    const uint32_t slot = n % NST;
    const int run = ((int)blockIdx.x + (int)(n / nseq) * (int)gridDim.x) / ntiles;
    const char* src = A.wf + ((size_t)run * nseq + n % nseq) * SLOT;
    mbar_expect_tx(&full[slot], SLOT);
    bulk_load(ring + slot * SLOT, src, SLOT / 2, &full[slot]);
    bulk_load(ring + slot * SLOT + SLOT / 2, src + SLOT / 2, SLOT / 2, &full[slot]);
  };
  // item k's agg rows into the stage, by warp 0
  auto stage = [&](int k) {
    const int w = blockIdx.x + k * gridDim.x;
    wg_stage_rows(st, A.agg + (size_t)(w / ntiles) * A.WP, A.lda, A.WP, (w % ntiles) * WG_TM,
                  A.M, staged);
  };
  if (threadIdx.x == 0) {
    for (uint32_t i = 0; i < NST; ++i) {
      mbar_init(&full[i], 1);
      done[i] = 0;
    }
    mbar_init(staged, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (uint32_t n = 0; n < NST; ++n) fill(n);
  if (threadIdx.x < 32 && my_items > 0) stage(0);
  const WgLane ln;
  const int n0 = ln.q * WN;
  const float invC = (float)A.H / HC;
  int buf = 0;
  uint32_t it = 0;
  float X[NT][4], P[NT][4];
  for (int k = 0; k < my_items; ++k) {
    const int w = blockIdx.x + k * gridDim.x, run = w / ntiles, row0 = (w % ntiles) * WG_TM;
    const float* seed = A.seed + (size_t)run * HC;
    const float* brff = A.brff + (size_t)run * A.L * HC;
    if (threadIdx.x < 32 && k + 1 < my_items) {  // warp 0: the next item's rows into L2
      const int nx = w + gridDim.x, nrow0 = (nx % ntiles) * WG_TM;
      for (int r = threadIdx.x; r < WG_TM && nrow0 + r < A.M; r += 32)
        prefetch_l2(A.agg + (size_t)(nx / ntiles) * A.WP + (size_t)(nrow0 + r) * A.lda,
                    A.WP * sizeof(T));
    }
    const bool ok0 = row0 + ln.row(0) < A.M, ok1 = row0 + ln.row(2) < A.M;
    float pa[2] = {0.f, 0.f}, pb[2] = {0.f, 0.f};
    // 1. out0 (the staged rows) and LN0 -> zb (in X)
    mbar_wait(staged, k & 1);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v, dinv;
        const float x = wg_out0<T, HC>(st, A.WP, ln.row(e), e < 2 ? ok0 : ok1,
                                       n0 + 8 * j + 2 * ln.t + (e & 1), invC, seed, v, dinv);
        X[j][e] = x;
        pa[e >> 1] += x;
        pb[e >> 1] += x * x;
      }
    wg_row_sum<NWG>(pa, pb, red, buf, ln);
    {
      const float* g0 = A.g0 + (size_t)run * HC;
      const float* b0 = A.b0 + (size_t)run * HC;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mu = pa[h] / HC;
        const float rstd = rsqrtf(pb[h] / HC - mu * mu + EPS);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int c = n0 + 8 * j + 2 * ln.t + q;
            const float xh = __fmul_rn(__fsub_rn(X[j][2 * h + q], mu), rstd);
            X[j][2 * h + q] = round_to<T>(__fadd_rn(__fmul_rn(xh, __ldg(g0 + c)), __ldg(b0 + c)));
          }
      }
    }
    __syncthreads();  // every warp is done with the staged rows
    wg_put_a<T, HC, NT>(X, sA, ln);
    __syncthreads();
    // 2. rFF with TorchDense rounding; p_l in P
    for (int l = 0; l < A.L; ++l) {
      wg_product<HC, NT, BF>(P, sA, ring, full, done, 4 * NWG, it, NST, ln, fill);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n0 + 8 * j + 2 * ln.t + (e & 1);
          P[j][e] = round_to<T>(__fadd_rn(round_to<T>(P[j][e]), __ldg(brff + l * HC + c)));
        }
      if (l + 1 < A.L) {  // h_1 = relu(p_0), exact in T
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) P[j][e] = fmaxf(P[j][e], 0.f);
        __syncthreads();  // every warp is done reading zb
        wg_put_a<T, HC, NT>(P, sA, ln);
        __syncthreads();
      }
    }
    __syncthreads();  // every warp is done with the last A operand: the next item's rows
    if (threadIdx.x < 32 && k + 1 < my_items) stage(k + 1);
    // 3. out2 = zb + relu(p_L-1), LN1, y straight out (rows past M are not)
    pa[0] = pa[1] = pb[0] = pb[1] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float o = __fadd_rn(X[j][e], fmaxf(P[j][e], 0.f));
        X[j][e] = o;
        pa[e >> 1] += o;
        pb[e >> 1] += o * o;
      }
    wg_row_sum<NWG>(pa, pb, red, buf, ln);
    {
      const float* g1 = A.g1 + (size_t)run * HC;
      const float* b1 = A.b1 + (size_t)run * HC;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mu = pa[h] / HC;
        const float rstd = rsqrtf(pb[h] / HC - mu * mu + EPS);
        T* yr = A.dagg + (size_t)run * HC + (size_t)(row0 + ln.row(2 * h)) * A.ldg;  // y
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = n0 + 8 * j + 2 * ln.t;
          float y[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float xh = __fmul_rn(__fsub_rn(X[j][2 * h + q], mu), rstd);
            y[q] = round_to<T>(__fadd_rn(__fmul_rn(xh, __ldg(g1 + c + q)), __ldg(b1 + c + q)));
            if (A.relu && !(y[q] > 0.f)) y[q] = 0.f;
          }
          if (h ? ok1 : ok0) store2(yr + c, y[0], y[1]);
        }
      }
    }
  }
}

template <typename T, int HC>
int launch_fwd_wg(const WgArgs<T>& A, int R, cudaStream_t s) {
  const WgLayout S = wg_layout(HC, A.WP, sizeof(T));
  if (S.nst < 2) return (int)cudaErrorInvalidValue;  // a ring of 2 slots at least
  cudaError_t e = cudaFuncSetAttribute(pma_fwd_wg_kernel<T, HC, HC / WG_N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S.bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long nwork = (long long)R * ((A.M + WG_TM - 1) / WG_TM);
  const int grid = (int)(nwork < sms ? nwork : sms);
  pma_fwd_wg_kernel<T, HC, HC / WG_N><<<grid, 2 * HC, S.bytes, s>>>(A, R);
  return (int)cudaGetLastError();
}

template <typename T, int HC>
int launch_bwd_wg(const WgArgs<T>& A, int R, float* dW, float* dsmall, float* part_w,
                  int grid_rows, int nch, int chunk_rows, int parts, cudaStream_t s) {
  cudaError_t e;
  if (parts & 1) {
    const WgLayout S = wg_layout(HC, A.WP, sizeof(T));
    if (S.nst < 2) return (int)cudaErrorInvalidValue;  // a ring of 2 slots at least
    e = cudaFuncSetAttribute(pma_bwd_wg_kernel<T, HC, HC / WG_N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S.bytes);
    if (e != cudaSuccess) return (int)e;
    pma_bwd_wg_kernel<T, HC, HC / WG_N><<<dim3(grid_rows, R), 2 * HC, S.bytes, s>>>(A);
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
    e = launch_reduce(part_w, nch, A.L * HC * HC, dW, A.part_small, grid_rows, 8 * HC, dsmall,
                      R, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3/K3R at HC 256. Inputs as allset_pma_epilogue_bwd's,
// with the weights as slabs (wf: forward, wb: backward; ops/cuda_pma.py::
// wg_weights). Scratch (allocated by the caller), per run: hT [R, L, HC,
// Mp] dtype, dpT [R, L, HC, Mp] f32, part_small [R, grid_rows, 8, HC] f32,
// part_w [R, nch, L, HC, HC] f32. parts: K3a (1), K3b (2), K3c (4).
int allset_pma_epilogue_bwd_wg(const void* agg, const void* gy, const void* seed,
                               const void* g0, const void* b0, const void* wf,
                               const void* wb, const void* brff, const void* g1,
                               const void* b1, void* dagg, void* dW, void* dsmall, void* hT,
                               void* dpT, void* part_small, void* part_w, int M, int Mp, int WP,
                               int HC, int H, int L, int R, int relu, int dtype, int grid_rows,
                               int nch, int chunk_rows, int parts, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || R <= 0) return (int)cudaGetLastError();
#define BWD_WG(T, HCV)                                                                    \
  if (HC == HCV) {                                                                        \
    WgArgs<T> A;                                                                          \
    A.agg = static_cast<const T*>(agg);                                                   \
    A.gy = static_cast<const T*>(gy);                                                     \
    A.seed = static_cast<const float*>(seed);                                             \
    A.g0 = static_cast<const float*>(g0);                                                 \
    A.b0 = static_cast<const float*>(b0);                                                 \
    A.brff = static_cast<const float*>(brff);                                             \
    A.g1 = static_cast<const float*>(g1);                                                 \
    A.b1 = static_cast<const float*>(b1);                                                 \
    A.wf = static_cast<const char*>(wf);                                                  \
    A.wb = static_cast<const char*>(wb);                                                  \
    A.dagg = static_cast<T*>(dagg);                                                       \
    A.hT = static_cast<T*>(hT);                                                           \
    A.dpT = static_cast<float*>(dpT);                                                     \
    A.part_small = static_cast<float*>(part_small);                                       \
    A.M = M, A.Mp = Mp, A.H = H, A.L = L, A.WP = WP, A.relu = relu;                       \
    A.lda = (size_t)R * WP;                                                               \
    A.ldg = (size_t)R * HC;                                                               \
    return launch_bwd_wg<T, HCV>(A, R, static_cast<float*>(dW), static_cast<float*>(dsmall), \
                                 static_cast<float*>(part_w), grid_rows, nch, chunk_rows,   \
                                 parts, s);                                                 \
  }
  if (dtype == 0) {
    BWD_WG(float, 256)
  } else {
    BWD_WG(__nv_bfloat16, 256)
  }
#undef BWD_WG
  return (int)cudaErrorInvalidValue;
}

// K2/K2R in f32 at HC 256 (bf16 keeps the tiled K2, faster there):
// inputs as allset_pma_epilogue_fwd's, with the weights as the forward
// slabs of ops/cuda_pma.py::wg_fwd_weights in place of Wf and Wbt.
// Returns 1 (cudaErrorInvalidValue) for another HC or dtype.
int allset_pma_epilogue_fwd_wg(const void* agg, const void* seed, const void* g0,
                               const void* b0, const void* wf, const void* brff,
                               const void* g1, const void* b1, void* out, int M, int WP, int HC,
                               int H, int L, int R, int relu, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || R <= 0) return (int)cudaGetLastError();
#define FWD_WG(T, HCV)                                                                     \
  if (HC == HCV) {                                                                         \
    WgArgs<T> A = {};                                                                      \
    A.agg = static_cast<const T*>(agg);                                                    \
    A.seed = static_cast<const float*>(seed);                                              \
    A.g0 = static_cast<const float*>(g0);                                                  \
    A.b0 = static_cast<const float*>(b0);                                                  \
    A.brff = static_cast<const float*>(brff);                                              \
    A.g1 = static_cast<const float*>(g1);                                                  \
    A.b1 = static_cast<const float*>(b1);                                                  \
    A.wf = static_cast<const char*>(wf);                                                   \
    A.dagg = static_cast<T*>(out);                                                         \
    A.M = M, A.H = H, A.L = L, A.WP = WP, A.relu = relu;                                   \
    A.lda = (size_t)R * WP;                                                                \
    A.ldg = (size_t)R * HC;                                                                \
    return launch_fwd_wg<T, HCV>(A, R, s);                                                 \
  }
  if (dtype == 0) {
    FWD_WG(float, 256)
  }
#undef FWD_WG
  return (int)cudaErrorInvalidValue;
}


}  // extern "C"
