// K2/K3 and K2R/K3R at widths above 512: the fused PMA epilogue's forward
// and backward (allset_tpu/ops/pallas_pma.py::_fwd_kernel and _bwd_kernel,
// their R = 1 and R > 1 grids) at any HC that is a multiple of 128 (640 ...
// 2048), given at run time. It replaces an earlier pair (f32 FMA
// products, intermediates in global scratch) that lost to its plain
// composition. The contract and the forward chain are those
// of pma_epilogue.cuh; the narrower widths run on pma_epilogue_wg.cu and
// pma_epilogue_cluster*.cu.
//
// What bounds it on the H100: the rFF products, 2 L HC^2 flops a row
// forward and three times that backward (dp @ W^T and h^T dp besides the
// recompute): 4.2 MFLOP a row at HC 1024, L 2, in the backward, against
// about 12 KB of row traffic. A whole output row does not fit beside a
// weight ring in one block (at HC 1024 a 64-row f32 A tile alone is 256 KB,
// more than the 227 KB a block may have), and a cluster holding a row
// would need HC / 128 blocks (16 at 2048, beyond the portable cluster
// size). So the row phases and the products run as separate kernels over
// [R, M, HC] tables, each with a fixed order of every sum; the products' A
// tables (zb, h1, dp_l) tiled by 128 rows and 128 bytes of columns (tab),
// so that a stage is one bulk copy:
//   * the products (wide_gemm_kernel): one persistent block per SM walks
//     the output tiles of 128 rows x 128 columns (bf16: two column tiles
//     at a time on one A stage), run by run, row tile by row tile, the
//     column tiles of a row tile side by side so that its A rows come from
//     L2 after the first. A producer thread (its warpgroup hands its
//     registers to the consumers' by setmaxnreg) keeps a ring of
//     NST stages full by two bulk copies a stage (cp.async.bulk, the TMA's
//     linear mode) completing on the stage's mbarrier: the tile's 128 A
//     rows of 128 bytes (16 KB, swizzled: conflict-free fragment reads),
//     and the weight slab of the same k-columns, laid out by the wrapper as
//     wgmma's K-major core matrices (ops/cuda_pma.py::wide_fwd_weights,
//     wide_bwd_weights). (One bulk copy per 128-byte row was tried first:
//     the copies' issue held the products to a seventh of their rate.)
//     Two consumer warpgroups, 64 rows each, issue m64n128 wgmma: bf16
//     products for the bf16 forward (k16) with A through descriptors (the
//     tiled layout is wgmma's K-major 128-byte swizzle atom; one stage's
//     products in flight while the next stage's are issued), 3xTF32 for
//     the f32 forward and for dp @ W^T in both dtypes (A split into TF32 hi
//     and lo in registers, the weights already split by the wrapper; a*b ~
//     al*bh + ah*bl + ah*bh, the error argument of pma_epilogue.cuh). Each
//     warp releases a stage to the producer once its products are done.
//     The epilogue of a tile is fused: the bias and the rounding points
//     (h = round(relu(round(round(acc) + b))) into the next layer's table,
//     or the last layer's p in f32), or, backward, the relu mask of the
//     layer below with the column sums of dbrff over the tile's rows, or
//     dz += dh into the table that holds LN1's backward;
//   * the row phases (wide_rows_kernel): a block takes a tile of 32 rows
//     (forward) or 128 (backward), 4096 / HC rows at a time (rounded to 4
//     or 2), each thread four
//     contiguous columns of every 1024; row statistics by a shuffle tree
//     and the eight warps in order, so K2 and K3's recompute give the same
//     bits. LN0 -> zb; LN1 -> y; LN1's backward (the relu mask of y, dout2
//     into the p table in place, dp of the last layer); LN0's backward and
//     dagg = [dv | dden | 0] (the heads' sums through shared memory, any
//     head count). The small-vector gradients are column sums over the
//     tile's rows in row order, one [8, HC] partial per 128-row tile;
//   * dW = h^T dp (wide_dw_kernel): over a few fixed row chunks (about 7
//     blocks an SM in all), as dW^T = dp^T h from the tiled
//     tables, K3b's design on bulk copies: dp's and h's rows staged as the
//     tables hold them, dp's fragments read transposed into registers
//     (bf16 h: dp = d1 + d2 + d3 exactly, three bf16 products with h as
//     staged, which is wgmma's N-major swizzled layout; f32 h: 3xTF32, h
//     rewritten as K-major core matrices of TF32 hi and lo once per stage);
//   * K3c's reduce (pma_epilogue.cuh, launch_reduce): the dW partials over
//     the chunks and the small vectors over the row tiles, in order.
// No floating-point atomics: two calls give the same bits, and run r of a
// folded launch equals a single-run launch on its slice bit for bit (the
// runs are the tiles' leading index; no order depends on R).

#include "pma_wgmma.cuh"

namespace {

constexpr int WD_TM = 128;            // rows per tile: products, row phases, partials
constexpr int WD_TN = 128;            // columns per product tile
constexpr int WD_CONS = 2;            // consumer warpgroups of a product block
constexpr int WD_GEMM_THREADS = 128 * (WD_CONS + 1);  // and a producer warpgroup
constexpr int WD_ROW_THREADS = 256;
constexpr int WD_MAX_HC = 2048;  // the row phases' columns: 2 chunks of 1024 a thread

enum { EP_H = 0, EP_V = 1, EP_DP = 2, EP_DZ = 3 };

// The products' A tables (zb, h1, dp_l) are tiled: [R, Mt, HC / KA, 128,
// KA], Mt = ceil(M / 128) row tiles of 128 rows (the last one padded), KA
// = 128 bytes of columns, and the 16-byte chunks of each 128-byte row
// XOR-swizzled by the row's low three bits. A product stage (128 rows x
// KA columns) is then one contiguous bulk copy, and its fragment reads
// fall on 32 distinct banks. tab: the element offset of (m, c) in a run's
// table; wd_mp: a run's rows.
template <typename T>
__host__ __device__ __forceinline__ size_t tab(int m, int c, int HC) {
  constexpr int KA = 128 / sizeof(T), V = 16 / sizeof(T);
  const int rr = m & (WD_TM - 1), cc = c % KA;
  return ((size_t)((m / WD_TM) * (HC / KA) + c / KA) * WD_TM + rr) * KA +
         (((cc / V) ^ (rr & 7)) * V) + cc % V;
}
__host__ __device__ __forceinline__ size_t wd_mp(int M) {
  return (size_t)(M + WD_TM - 1) / WD_TM * WD_TM;
}
enum { ROW_LN0 = 0, ROW_LN1 = 1, ROW_LN1_BWD = 2, ROW_LN0_BWD = 3 };

__device__ __forceinline__ float wd_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<const uint32_t*>(&a);
  x.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = x;
}

// --- the row phases -------------------------------------------------------------

template <typename T>
struct RowArgs {
  const T* agg;  // [M, R WP]
  const T* gy;   // [M, R HC]
  const float *seed, *g0, *b0, *g1, *b1;  // [R, HC]
  T* zb;         // [R, Mp, HC] tiled (tab)
  float* pz;     // [R, M, HC]: p of the last layer (f32), then dz in place
  float* dp;     // [R, Mp, HC] tiled: dp of the last layer
  T* out;        // y [M, R HC] or dagg [M, R WP]
  float* part;   // [R, NP, 8, HC]
  int M, WP, HC, H, L, R, relu;
};

// Row totals of two per-row sums over the block: a shuffle tree in each
// warp, then the eight warps in order (every thread gets the same bits).
template <int TR>
__device__ __forceinline__ void block_row_sums(float (&a)[TR], float (&b)[TR], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    a[i] = wd_warp_sum(a[i]);
    b[i] = wd_warp_sum(b[i]);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      red[(warp * TR + i) * 2] = a[i];
      red[(warp * TR + i) * 2 + 1] = b[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int w = 0; w < WD_ROW_THREADS / 32; ++w) {
      s += red[(w * TR + i) * 2];
      s2 += red[(w * TR + i) * 2 + 1];
    }
    a[i] = s;
    b[i] = s2;
  }
  __syncthreads();  // red is reused
}

__device__ __forceinline__ float2 ln_stats(float s, float s2, int HC) {
  const float mu = s / HC;
  return make_float2(mu, rsqrtf(s2 / HC - mu * mu + EPS));
}

// One thread's columns: chunk k covers [4 (tid + 256 k), + 4).
template <int NCH>
struct Cols {
  int c[NCH];
  bool on[NCH];
  __device__ Cols(int HC) {
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      c[k] = 4 * (threadIdx.x + WD_ROW_THREADS * k);
      on[k] = c[k] < HC;
    }
  }
};

// 1 / max(den, floor) of four columns' heads (correctly rounded, as 1.f /
// x), loaded and computed once per run of equal heads.
template <typename T>
__device__ __forceinline__ void den_inv(const T* den, const int (&hd)[4], float (&inv)[4]) {
  inv[0] = __frcp_rn(fmaxf(to_f(den[hd[0]]), DEN_FLOOR));
#pragma unroll
  for (int u = 1; u < 4; ++u)
    inv[u] = hd[u] == hd[u - 1] ? inv[u - 1] : __frcp_rn(fmaxf(to_f(den[hd[u]]), DEN_FLOOR));
}

// out0 = vals / max(den, floor) + seed of TR rows (zeros past M) and their
// (sum, sum of squares); LN0's statistics in st. Shared by LN0 and its
// backward, so both take the same bits.
template <typename T, int NCH, int TR>
__device__ __forceinline__ void out0_rows(const RowArgs<T>& A, int run, int m0, const Cols<NCH>& cl,
                                          const float (&seed)[NCH][4], const int (&hd)[NCH][4],
                                          float (&x)[TR][4 * NCH], float2 (&st)[TR], float* red) {
  const size_t lda = (size_t)A.R * A.WP;
  float s[TR], s2[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int m = m0 + i;
    s[i] = s2[i] = 0.f;
    const T* a = A.agg + (size_t)(m < A.M ? m : 0) * lda + (size_t)run * A.WP;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (cl.on[k] && m < A.M) {
        ld4(a + cl.c[k], v);
        float inv[4];
        den_inv(a + A.HC, hd[k], inv);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v[u] = v[u] * inv[u] + seed[k][u];
          s[i] += v[u];
          s2[i] += v[u] * v[u];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) x[i][4 * k + u] = v[u];
    }
  }
  block_row_sums<TR>(s, s2, red);
#pragma unroll
  for (int i = 0; i < TR; ++i) st[i] = ln_stats(s[i], s2[i], A.HC);
}

// out2 = zb + relu(p_last) of TR rows and LN1's statistics; vm: the mask
// p_last > 0, bit 4 k + u of row i. Shared by LN1 and its backward.
template <typename T, int NCH, int TR>
__device__ __forceinline__ void out2_rows(const RowArgs<T>& A, int run, int m0, const Cols<NCH>& cl,
                                          float (&x)[TR][4 * NCH], float2 (&st)[TR],
                                          uint32_t (&vm)[TR], float* red) {
  float s[TR], s2[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int m = m0 + i;
    s[i] = s2[i] = 0.f;
    vm[i] = 0u;
    const int mm = m < A.M ? m : 0;
    const size_t off = ((size_t)run * A.M + mm) * A.HC;
    const T* zb = A.zb + run * wd_mp(A.M) * A.HC;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      float z[4] = {0.f, 0.f, 0.f, 0.f}, p[4] = {0.f, 0.f, 0.f, 0.f};
      if (cl.on[k] && m < A.M) {
        ld4(zb + tab<T>(mm, cl.c[k], A.HC), z);
        ld4(A.pz + off + cl.c[k], p);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float v = z[u] + fmaxf(p[u], 0.f);
        if (p[u] > 0.f) vm[i] |= 1u << (4 * k + u);
        x[i][4 * k + u] = v;
        s[i] += v;
        s2[i] += v * v;
      }
    }
  }
  block_row_sums<TR>(s, s2, red);
#pragma unroll
  for (int i = 0; i < TR; ++i) st[i] = ln_stats(s[i], s2[i], A.HC);
}

__device__ __forceinline__ float ln_out(float xh, float g, float b) { return xh * g + b; }

// A block takes the 128-row tile blockIdx.x of run blockIdx.y, TR rows at
// a time. MODE: ROW_LN0 (agg -> zb), ROW_LN1 (zb, p -> y), ROW_LN1_BWD
// (zb, p, gy -> dz over p, dp of the last layer; partials dg1, db1,
// dbrff[L-1]), ROW_LN0_BWD (agg, dz -> dagg; partials dseed, dg0, db0 and
// the zero rows).
template <typename T, int MODE, int NCH>
__global__ void __launch_bounds__(WD_ROW_THREADS, MODE == ROW_LN0 || MODE == ROW_LN1 ? 3 : 2)
    wide_rows_kernel(RowArgs<T> A) {
  constexpr int TR = 4 / NCH, NV = 4 * NCH;  // (8 / NCH rows took 210 registers: one block an SM)
  __shared__ float red[(WD_ROW_THREADS / 32) * TR * 2];
  __shared__ float prod[MODE == ROW_LN0_BWD ? TR * 1024 * NCH : 1];
  // the forward's phases take 32-row tiles (more blocks); the backward's
  // 128, each tile a set of partials
  constexpr int TILE = MODE == ROW_LN0 || MODE == ROW_LN1 ? 32 : WD_TM;
  const int run = blockIdx.y, tile = blockIdx.x, row0 = tile * TILE, HC = A.HC;
  const Cols<NCH> cl(HC);
  const float* g = (MODE == ROW_LN0 || MODE == ROW_LN0_BWD ? A.g0 : A.g1) + (size_t)run * HC;
  const float* b = (MODE == ROW_LN0 || MODE == ROW_LN0_BWD ? A.b0 : A.b1) + (size_t)run * HC;
  float gc[NCH][4], bc[NCH][4], seed[NCH][4];
  int hd[NCH][4];
  const int C = HC / A.H;
#pragma unroll
  for (int k = 0; k < NCH; ++k)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = cl.on[k] ? cl.c[k] + u : 0;
      gc[k][u] = g[c];
      bc[k][u] = b[c];
      seed[k][u] = A.seed[(size_t)run * HC + c];
      hd[k][u] = c / C;
    }
  float cs[3][NV];  // the block's column partials
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int j = 0; j < NV; ++j) cs[q][j] = 0.f;
  const size_t lda = (size_t)A.R * A.WP;

#pragma unroll 1
  for (int i0 = 0; i0 < TILE; i0 += TR) {
    const int m0 = row0 + i0;
    if (m0 >= A.M) break;  // uniform over the block
    float x[TR][NV];
    float2 st[TR];
    if constexpr (MODE == ROW_LN0 || MODE == ROW_LN0_BWD) {
      out0_rows<T, NCH, TR>(A, run, m0, cl, seed, hd, x, st, red);
    } else {
      uint32_t vm[TR];
      out2_rows<T, NCH, TR>(A, run, m0, cl, x, st, vm, red);
      if constexpr (MODE == ROW_LN1) {
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int m = m0 + i;
          if (m >= A.M) continue;
          T* y = A.out + (size_t)m * A.R * HC + (size_t)run * HC;
#pragma unroll
          for (int k = 0; k < NCH; ++k) {
            if (!cl.on[k]) continue;
            float v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float xh = (x[i][4 * k + u] - st[i].x) * st[i].y;
              v[u] = round_to<T>(ln_out(xh, gc[k][u], bc[k][u]));
              if (A.relu) v[u] = fmaxf(v[u], 0.f);
            }
            st4(y + cl.c[k], v);
          }
        }
      } else {  // ROW_LN1_BWD
        float gg[TR][NV], s1[TR], s2[TR];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int m = m0 + i;
          s1[i] = s2[i] = 0.f;
          const T* gy = A.gy + (size_t)(m < A.M ? m : 0) * A.R * HC + (size_t)run * HC;
#pragma unroll
          for (int k = 0; k < NCH; ++k) {
            float gv[4] = {0.f, 0.f, 0.f, 0.f};
            if (cl.on[k] && m < A.M) ld4(gy + cl.c[k], gv);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int j = 4 * k + u;
              const float xh = (x[i][j] - st[i].x) * st[i].y;
              float gr = gv[u];
              // the mask on the ROUNDED output, as the forward computes it
              if (A.relu && !(round_to<T>(ln_out(xh, gc[k][u], bc[k][u])) > 0.f)) gr = 0.f;
              cs[0][j] += gr * xh;  // dg1
              cs[1][j] += gr;       // db1
              gg[i][j] = gr * gc[k][u];
              x[i][j] = xh;
              s1[i] += gg[i][j];
              s2[i] += gg[i][j] * xh;
            }
          }
        }
        block_row_sums<TR>(s1, s2, red);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int m = m0 + i;
          if (m >= A.M) continue;
          const float m1 = s1[i] / HC, m2 = s2[i] / HC;
          const size_t off = ((size_t)run * A.M + m) * HC;
#pragma unroll
          for (int k = 0; k < NCH; ++k) {
            if (!cl.on[k]) continue;
            float d[4], dpv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int j = 4 * k + u;
              d[u] = st[i].y * (gg[i][j] - m1 - x[i][j] * m2);
              dpv[u] = (vm[i] >> j) & 1u ? d[u] : 0.f;
              cs[2][j] += dpv[u];  // dbrff[L-1]
            }
            st4(A.pz + off + cl.c[k], d);
            st4(A.dp + run * wd_mp(A.M) * HC + tab<float>(m, cl.c[k], HC), dpv);
          }
        }
      }
    }
    if constexpr (MODE == ROW_LN0) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int m = m0 + i;
        if (m >= A.M) continue;
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          if (!cl.on[k]) continue;
          float z[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            z[u] = round_to<T>(ln_out((x[i][4 * k + u] - st[i].x) * st[i].y, gc[k][u], bc[k][u]));
          st4(A.zb + run * wd_mp(A.M) * HC + tab<T>(m, cl.c[k], HC), z);
        }
      }
    }
    if constexpr (MODE == ROW_LN0_BWD) {
      float gg[TR][NV], s1[TR], s2[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int m = m0 + i;
        s1[i] = s2[i] = 0.f;
        const size_t off = ((size_t)run * A.M + (m < A.M ? m : 0)) * HC;
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          float dz[4] = {0.f, 0.f, 0.f, 0.f};
          if (cl.on[k] && m < A.M) ld4(A.pz + off + cl.c[k], dz);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = 4 * k + u;
            const float xh = (x[i][j] - st[i].x) * st[i].y;
            cs[1][j] += dz[u] * xh;  // dg0
            cs[2][j] += dz[u];       // db0
            gg[i][j] = dz[u] * gc[k][u];
            x[i][j] = xh;
            s1[i] += gg[i][j];
            s2[i] += gg[i][j] * xh;
          }
        }
      }
      block_row_sums<TR>(s1, s2, red);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int m = m0 + i;
        const float m1 = s1[i] / HC, m2 = s2[i] / HC;
        const T* a = A.agg + (size_t)(m < A.M ? m : 0) * lda + (size_t)run * A.WP;
        T* da = A.out + (size_t)m * lda + (size_t)run * A.WP;
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          if (!cl.on[k]) continue;
          float vals[4] = {0.f, 0.f, 0.f, 0.f}, dv[4], inv[4];
          if (m < A.M) ld4(a + cl.c[k], vals);
          den_inv(a + HC, hd[k], inv);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = 4 * k + u;
            const float d0 = m < A.M ? st[i].y * (gg[i][j] - m1 - x[i][j] * m2) : 0.f;
            cs[0][j] += d0;  // dseed
            dv[u] = d0 * inv[u];
            prod[i * HC + cl.c[k] + u] = d0 * vals[u];
          }
          if (m < A.M) st4(da + cl.c[k], dv);
        }
      }
      __syncthreads();
      // dden[row][h] = -sum over the head's C columns of d0 * vals, times
      // 1 / den^2 (0 where den <= floor): a group of S lanes per (row,
      // head), S the largest power of two up to min(C, 32), the lanes'
      // strided sums then a shuffle tree
      int S = 1;
      while (S * 2 <= C && S < 32) S *= 2;
      const int per = WD_ROW_THREADS / S, ntask = TR * A.H, li = threadIdx.x % S;
      for (int p0 = 0; p0 < ntask; p0 += per) {
        const int task = p0 + threadIdx.x / S;
        const int i = task / A.H, h = task % A.H;
        float s = 0.f;
        if (task < ntask)
          for (int c = h * C + li; c < (h + 1) * C; c += S) s += prod[i * HC + c];
        for (int o = S / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        const int m = m0 + i;
        if (task < ntask && li == 0 && m < A.M) {
          const T* a = A.agg + (size_t)m * lda + (size_t)run * A.WP;
          const float den = to_f(a[HC + h]), inv = __frcp_rn(fmaxf(den, DEN_FLOOR));
          A.out[(size_t)m * lda + (size_t)run * A.WP + HC + h] =
              from_f<T>(den > DEN_FLOOR ? -s * (inv * inv) : 0.f);
        }
      }
      for (int j = threadIdx.x; j < TR * (A.WP - HC - A.H); j += WD_ROW_THREADS) {
        const int i = j / (A.WP - HC - A.H), c = HC + A.H + j % (A.WP - HC - A.H);
        if (m0 + i < A.M) A.out[(size_t)(m0 + i) * lda + (size_t)run * A.WP + c] = from_f<T>(0.f);
      }
      __syncthreads();  // prod is reused
    }
  }
  if constexpr (MODE == ROW_LN1_BWD || MODE == ROW_LN0_BWD) {
    const int NP = (A.M + WD_TM - 1) / WD_TM;
    float* part = A.part + ((size_t)run * NP + tile) * 8 * HC;
    const int q0 = MODE == ROW_LN1_BWD ? 3 : 0;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      if (!cl.on[k]) continue;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        // ROW_LN1_BWD: dg1 (3), db1 (4), dbrff[L-1] (5 + L - 1)
        const int row = MODE == ROW_LN1_BWD ? (q < 2 ? 3 + q : 4 + A.L) : q0 + q;
        const float v[4] = {cs[q][4 * k], cs[q][4 * k + 1], cs[q][4 * k + 2], cs[q][4 * k + 3]};
        st4(part + (size_t)row * HC + cl.c[k], v);
      }
      if (MODE == ROW_LN0_BWD) {
        const float z[4] = {0.f, 0.f, 0.f, 0.f};
        for (int row = 5 + A.L; row < 8; ++row) st4(part + (size_t)row * HC + cl.c[k], z);
      }
    }
  }
}

// --- the products --------------------------------------------------------------

// d[64, 128] += A[64, k16] x B, bf16, both from shared memory (descriptors)
#define WD_D4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[16][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WD_D4(0), WD_D4(1), WD_D4(2), WD_D4(3), WD_D4(4), WD_D4(5), WD_D4(6), WD_D4(7),
        WD_D4(8), WD_D4(9), WD_D4(10), WD_D4(11), WD_D4(12), WD_D4(13), WD_D4(14), WD_D4(15)
      : "l"(da), "l"(db), "r"(1));
}
#undef WD_D4

// Descriptor of a K-major operand in the 128-byte swizzle: 8-row groups
// of 128-byte rows 1024 bytes apart, the rows' 16-byte chunks XOR-swizzled
// by the row's low three bits (tab's layout); the atom 1024-byte aligned,
// a k step inside it by the start address
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// An item: the 128 rows of a row tile against TPI column tiles of 128
// (bf16: two, so that each A stage feeds twice the products; the last
// item of an odd count has one; f32: one). A stage: the item's 128 A rows
// of KA k-columns (128 bytes each, as tab lays them out), then the weight
// slab of the same k-columns for each of its column tiles (bf16: one
// WG_KSB slab; f32: two WG_KSF slabs of TF32 hi | lo); a bulk copy each.
template <typename TA>
struct GemmPlan {
  static constexpr bool BF = sizeof(TA) == 2;
  static constexpr int TPI = BF ? 2 : 1;
  static constexpr int KA = 128 / sizeof(TA);  // k-columns a stage
  static constexpr int A_BYTES = WD_TM * 128;
  static constexpr int B_BYTES = BF ? KA * WD_TN * 2 : KA * WD_TN * 8;
  static constexpr int STAGE = A_BYTES + TPI * B_BYTES;
  static constexpr int NST = 4;
  static constexpr int RED = WD_CONS * 4 * WD_TN * 4;  // the epilogue's column sums
  static constexpr int bytes = NST * STAGE + RED + 2 * NST * 8 + 1024;  // + alignment
};

template <typename TA, typename T>
struct GemmArgs {
  const TA* A;       // [R, Mp, HC] tiled (tab)
  const char* B;     // [R, L, HC / 128, HC / KA, B_BYTES]
  const float* bias; // [R, L, HC] (forward)
  T* h;              // tiled; EP_H: h of the next layer; EP_DP: the mask (h of this layer)
  float* out;        // EP_V: p, EP_DZ: dz (+=), [R, M, HC]; EP_DP: dp of the layer
                     // below, tiled (f32: may be h)
  float* part;       // EP_DP: [R, NP, 8, HC], row q
  int M, HC, L, l, mode, q;
};

template <typename TA, typename T>
__global__ void __launch_bounds__(WD_GEMM_THREADS, 1) wide_gemm_kernel(GemmArgs<TA, T> g, int R) {
  using P = GemmPlan<TA>;
  constexpr int NST = P::NST, KA = P::KA, TPI = P::TPI;
  constexpr uint32_t LBO = WD_TN * 16;  // bytes between the k chunks of a slab
  extern __shared__ __align__(128) char smem_raw[];
  // the stages 1024-byte aligned: the 128-byte swizzle's atom
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(smem + NST * P::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NST * P::STAGE + P::RED);
  uint64_t* empty = full + NST;
  const int M = g.M, HC = g.HC;
  const int ntm = (M + WD_TM - 1) / WD_TM, ntn = HC / WD_TN, nk = HC / KA;
  const int nti = (ntn + TPI - 1) / TPI;  // items per row tile
  const int nitems = R * ntm * nti;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WD_CONS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // the producer warpgroup gives up registers for the consumers' (a block
  // is allocated registers by warpgroups: 168 a thread without this)
  if (threadIdx.x >= 128 * WD_CONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 128 * WD_CONS) return;  // one thread issues the copies
    uint32_t it = 0;
    for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
      const int tp = item % nti, tm = (item / nti) % ntm, run = item / (nti * ntm);
      const int ncol = min(TPI, ntn - tp * TPI);
      // the row tile's stages, one after another (tab)
      const TA* a = g.A + run * wd_mp(M) * HC + (size_t)tm * WD_TM * HC;
      const char* b = g.B + (((size_t)run * g.L + g.l) * ntn + tp * TPI) * (size_t)nk * P::B_BYTES;
      for (int s = 0; s < nk; ++s, ++it) {
        const uint32_t slot = it % NST;
        if (it >= (uint32_t)NST) mbar_wait(&empty[slot], ((it / NST) - 1) & 1);
        char* st = smem + slot * P::STAGE;
        mbar_expect_tx(&full[slot], P::A_BYTES + ncol * P::B_BYTES);
        bulk_load(st, a + (size_t)s * WD_TM * KA, P::A_BYTES, &full[slot]);
        for (int c = 0; c < ncol; ++c)
          bulk_load(st + P::A_BYTES + c * P::B_BYTES,
                    b + ((size_t)c * nk + s) * P::B_BYTES, P::B_BYTES, &full[slot]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const WgLane ln;  // q: the consumer warpgroup, its rows [64 q, 64 q + 64)
  const int r0 = 64 * ln.q + 16 * ln.w + ln.g;
  // each warp counts itself done with stage n's slot
  auto release = [&](uint32_t n) {
    __syncwarp();
    if (lane == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(&empty[n % NST]))
                   : "memory");
  };
  // the fused epilogue of column tile tn: element (j, e) of acc is row 16 w
  // + g + 8 (e / 2) of the warpgroup's 64, column 8 j + 2 t + e % 2
  auto epilogue = [&](float (&acc)[16][4], int run, int tm, int tn) {
    const int row0 = tm * WD_TM, col0 = tn * WD_TN;
    const size_t rbase = (size_t)run * M, toff = run * wd_mp(M) * HC;
    const float* bias = g.bias ? g.bias + ((size_t)run * g.L + g.l) * HC + col0 : nullptr;
    float csum[16][2];
#pragma unroll
    for (int j = 0; j < 16; ++j) csum[j][0] = csum[j][1] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + r0 + 8 * h;
      if (m >= M) continue;
      const size_t off = (rbase + m) * HC + col0 + 2 * ln.t;
      // the row's masks or dz first, all loads in flight together (a load
      // after each store left each of them waiting on the last)
      float2 in[16];
      if (g.mode == EP_DP) {
#pragma unroll
        for (int j = 0; j < 16; ++j) in[j] = load2(g.h + toff + tab<T>(m, col0 + 8 * j + 2 * ln.t, HC));
      } else if (g.mode == EP_DZ) {
#pragma unroll
        for (int j = 0; j < 16; ++j) in[j] = load2(g.out + off + 8 * j);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float x0 = acc[j][2 * h], x1 = acc[j][2 * h + 1];
        const int c = 8 * j, col = col0 + c + 2 * ln.t;
        if (g.mode == EP_H || g.mode == EP_V) {
          const float2 bv = *reinterpret_cast<const float2*>(bias + c + 2 * ln.t);
          const float v0 = round_to<T>(round_to<T>(x0) + bv.x);
          const float v1 = round_to<T>(round_to<T>(x1) + bv.y);
          if (g.mode == EP_H)
            store2(g.h + toff + tab<T>(m, col, HC), fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          else
            store2(g.out + off + c, v0, v1);
        } else if (g.mode == EP_DP) {
          const float d0 = in[j].x > 0.f ? x0 : 0.f, d1 = in[j].y > 0.f ? x1 : 0.f;
          store2(g.out + toff + tab<float>(m, col, HC), d0, d1);
          csum[j][0] += d0;
          csum[j][1] += d1;
        } else {  // EP_DZ
          store2(g.out + off + c, in[j].x + x0, in[j].y + x1);
        }
      }
    }
    if (g.mode == EP_DP) {
      // the tile's column sums: the thread's two rows, the g lanes by a
      // shuffle tree, the eight warps in order; one partial per row tile
      const int cw = 4 * ln.q + ln.w;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = csum[j][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (ln.g == 0) red[cw * WD_TN + 8 * j + 2 * ln.t + e] = v;
        }
      asm volatile("bar.sync 1, %0;\n" ::"n"(128 * WD_CONS) : "memory");
      if (threadIdx.x < WD_TN) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WD_CONS * 4; ++w) s += red[w * WD_TN + threadIdx.x];
        g.part[(((size_t)run * ntm + tm) * 8 + g.q) * HC + col0 + threadIdx.x] = s;
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(128 * WD_CONS) : "memory");
    }
  };
  uint32_t it = 0;
  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    const int tp = item % nti, tm = (item / nti) % ntm, run = item / (nti * ntm);
    float acc[TPI][16][4];
#pragma unroll
    for (int c = 0; c < TPI; ++c)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < TPI; ++c) fence_acc(acc[c]);
    if constexpr (P::BF) {
      // A through descriptors: tab's layout is wgmma's K-major 128-byte
      // swizzle atom, the warpgroup's 64 rows 8 KB into the stage; one
      // stage's products in flight while the next stage's are issued
      // (an odd count's last item multiplies its second, unloaded slab too,
      // and drops the result: no branch around the products)
      wg_fence();
#pragma unroll 1
      for (int s = 0; s < nk; ++s, ++it) {
        const uint32_t slot = it % NST;
        mbar_wait(&full[slot], (it / NST) & 1);
        const uint32_t sa = smem_u32(smem + slot * P::STAGE) + ln.q * 64 * 128;
        const uint32_t bb = smem_u32(smem + slot * P::STAGE + P::A_BYTES);
#pragma unroll
        for (int kk = 0; kk < KA / 16; ++kk) {
          const uint64_t da = desc_sw128(sa + 32 * kk);
          wgmma_bf16_ss(acc[0], da, desc_k(bb + 2 * kk * LBO, LBO, 128));
          wgmma_bf16_ss(acc[TPI - 1], da, desc_k(bb + P::B_BYTES + 2 * kk * LBO, LBO, 128));
        }
        wg_commit();
        if (s > 0) {
          wg_wait<1>();
          release(it - 1);
        }
      }
      wg_wait<0>();
      release(it - 1);
    } else {
      // A from registers, split into TF32 hi and lo (rows r0 and r0 + 8,
      // whose low three bits are g: chunk j of a row at chunk j ^ g); a
      // stage's products are done before its registers are reused (two
      // register sets with a stage in flight measured no faster)
#pragma unroll 1
      for (int s = 0; s < nk; ++s, ++it) {
        const uint32_t slot = it % NST;
        mbar_wait(&full[slot], (it / NST) & 1);
        const char* st = smem + slot * P::STAGE;
        const float* a = reinterpret_cast<const float*>(st) + r0 * KA + ln.t;
        uint32_t ah[KA / 8][4], al[KA / 8][4];
#pragma unroll
        for (int kk = 0; kk < KA / 8; ++kk) {
          const float* p0 = a + ((2 * kk) ^ ln.g) * 4;
          const float* p1 = a + ((2 * kk + 1) ^ ln.g) * 4;
          split_tf32(p0[0], ah[kk][0], al[kk][0]);
          split_tf32(p0[8 * KA], ah[kk][1], al[kk][1]);
          split_tf32(p1[0], ah[kk][2], al[kk][2]);
          split_tf32(p1[8 * KA], ah[kk][3], al[kk][3]);
        }
        const uint32_t bb = smem_u32(st + P::A_BYTES);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KA / 8; ++kk) {
          // host slab kk / 2 (hi, then lo WG_KSF * 128 * 4 bytes on), its k8 step kk % 2
          const uint32_t bh = bb + (kk >> 1) * (WG_KSF * WD_TN * 8) + (kk & 1) * 2 * LBO;
          const uint32_t bl = bh + WG_KSF * WD_TN * 4;
          wgmma_tf32(acc[0], al[kk], desc_k(bh, LBO, 128));
          wgmma_tf32(acc[0], ah[kk], desc_k(bl, LBO, 128));
          wgmma_tf32(acc[0], ah[kk], desc_k(bh, LBO, 128));
        }
        wg_commit();
        wg_wait<0>();
        fence_acc(acc[0]);
        release(it);
      }
    }
#pragma unroll
    for (int c = 0; c < TPI; ++c) {
      fence_acc(acc[c]);
      if (tp * TPI + c < ntn) epilogue(acc[c], run, tm, tp * TPI + c);
    }
  }
}

// --- dW = h^T dp over fixed row chunks ----------------------------------------------

// part[run][ch][l] = h_l^T dp_l over the rows of chunk ch, from the
// tiled tables (tab), as dW^T = dp^T h: a block takes a 128 (j) x 128 (i)
// tile, each of its two warpgroups 64 j-rows of it against the same h
// rows, the chunk's rows KR at a time through three stages, each filled by
// thread 0's bulk copies (one per 128-byte column block of h and of dp:
// the tables hold a block's rows contiguous, and zeros past M) completing
// on the stage's mbarrier. dp's fragments are read transposed from the
// staged rows; bf16 h is used as staged, which is wgmma's N-major 128-byte
// swizzle layout (B through a transposing descriptor); f32 h is rewritten
// as K-major core matrices of TF32 hi | lo once per stage (TF32 products
// take K-major operands only), the next step's while this step's
// products run. blockIdx.x = ((run * nch + ch) * (HC / 128)
// + jt) * (HC / 128) + it: the tiles of one chunk run side by side and
// share its rows in L2.
template <typename T>
struct DwPlan {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int BJ = 128, BN = 128, NTB = BN / 8;
  static constexpr int KR = F32 ? 16 : 32;      // rows per stage
  static constexpr int KA = 128 / sizeof(T);    // h's columns a 128-byte block
  // a stage: h's KR rows (BN / KA blocks of KR x 128 bytes), then dp's (4
  // blocks); 1024-byte aligned (the swizzle atom)
  static constexpr int H_BYTES = KR * BN * (int)sizeof(T);
  static constexpr int STAGE = H_BYTES + KR * BJ * 4;
  static constexpr int B_PART = KR * BN * 4;  // f32: one TF32 part of h, K-major
  static constexpr int HL = F32 ? 4 * B_PART : 0;  // f32: two buffers of hi | lo
  static constexpr int STAGES = 3;
  static constexpr int bytes = STAGES * STAGE + HL + STAGES * 8 + 1024;  // + alignment
};

// d[64, 128] += A[64, k16] (registers) x B, bf16, B N-major through a
// descriptor (imm-trans-b)
#define WD_D4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
__device__ __forceinline__ void wgmma_bf16_tb(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WD_D4(0), WD_D4(1), WD_D4(2), WD_D4(3), WD_D4(4), WD_D4(5), WD_D4(6), WD_D4(7),
        WD_D4(8), WD_D4(9), WD_D4(10), WD_D4(11), WD_D4(12), WD_D4(13), WD_D4(14), WD_D4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef WD_D4

// Descriptor of an MN-major operand in the 128-byte swizzle: atoms of 8
// k-rows x 128 bytes (64 bf16 of N), the rows' 16-byte chunks
// XOR-swizzled by the row's low three bits; lbo the bytes between atoms
// along N, 1024 between the 8-row groups along k
__device__ __forceinline__ uint64_t desc_mn128(uint32_t saddr, uint32_t lbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

template <typename T>
__global__ void __launch_bounds__(256, 2)
    wide_dw_kernel(const T* __restrict__ h, const float* __restrict__ dp, int M, int HC, int L,
                   int l, int nch, int chunk_rows, float* __restrict__ part) {
  using D = DwPlan<T>;
  constexpr int BJ = D::BJ, BN = D::BN, NTB = D::NTB, KR = D::KR, KA = D::KA;
  constexpr int NSTG = D::STAGES, NTH = 256;
  constexpr uint32_t LBO = BN * 16;  // f32: bytes between the k chunks of B
  extern __shared__ __align__(128) char smem_raw[];
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  char* hl = smem + NSTG * D::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(hl + D::HL);
  const int nt = HC / 128;
  int b = blockIdx.x;
  const int itile = b % nt;
  b /= nt;
  const int jt = b % nt;
  b /= nt;
  const int ch = b % nch, run = b / nch;
  const int i0 = itile * BN, j0 = jt * BJ;
  h += run * wd_mp(M) * HC;
  dp += run * wd_mp(M) * HC;
  part += (((size_t)run * nch + ch) * L + l) * (size_t)HC * HC;
  const int r_begin = ch * chunk_rows, r_end = min(M, r_begin + chunk_rows);
  const int nsteps = r_end > r_begin ? (r_end - r_begin + KR - 1) / KR : 0;
  const int q = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NSTG; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // stage st: the KR rows from rs (a multiple of KR: whole rows of one
  // 128-row tile; a chunk's last stage ends at its end or past M, where
  // the tables hold zeros)
  auto load = [&](int st, int rs) {
    char* hh = smem + st * D::STAGE;
    mbar_expect_tx(&full[st], D::STAGE);
#pragma unroll
    for (int c = 0; c < BN / KA; ++c)
      bulk_load(hh + c * KR * 128, h + tab<T>(rs, i0 + c * KA, HC), KR * 128, &full[st]);
#pragma unroll
    for (int c = 0; c < BJ / 32; ++c)
      bulk_load(hh + D::H_BYTES + c * KR * 128, dp + tab<float>(rs, j0 + c * 32, HC), KR * 128,
                &full[st]);
  };
  float acc[NTB][4];
#pragma unroll
  for (int j = 0; j < NTB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  fence_acc(acc);
  if (threadIdx.x == 0)
    for (int s = 0; s < NSTG - 1 && s < nsteps; ++s) load(s, r_begin + s * KR);
  const int jr = 64 * q + 16 * w + g;
  // dp's element (row k, column j) of stage st, in its swizzled blocks
  auto dpe = [&](int st, int k, int j) {
    const float* d = reinterpret_cast<const float*>(smem + st * D::STAGE + D::H_BYTES);
    return d[(j >> 5) * KR * 32 + k * 32 + ((((j & 31) >> 2) ^ (k & 7)) << 2) + (j & 3)];
  };
  // f32: step st's h rows into hl buffer st % 2 as wgmma's K-major core
  // matrices, element (i, k) at (k / 4) LBO + (i / 8) 128 + (i % 8) 16 + (k
  // % 4) 4, TF32 hi and lo B_PART on
  auto split_h = [&](int st) {
    mbar_wait(&full[st % NSTG], (st / NSTG) & 1);
    const float* raw = reinterpret_cast<const float*>(smem + (st % NSTG) * D::STAGE);
    char* out = hl + (st & 1) * 2 * D::B_PART;
    for (int e = threadIdx.x; e < BN * KR; e += NTH) {
      const int kc = e / (BN * 4), ii = (e / 4) % BN, rr = e % 4, k = kc * 4 + rr;
      uint32_t hi, lo;
      split_tf32(raw[(ii >> 5) * KR * 32 + k * 32 + ((((ii & 31) >> 2) ^ (k & 7)) << 2) +
                     (ii & 3)],
                 hi, lo);
      const int o = kc * LBO + (ii >> 3) * 128 + (ii & 7) * 16 + rr * 4;
      *reinterpret_cast<uint32_t*>(out + o) = hi;
      *reinterpret_cast<uint32_t*>(out + D::B_PART + o) = lo;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  if constexpr (D::F32) {
    if (nsteps > 0) split_h(0);
    __syncthreads();
  }
#pragma unroll 1
  for (int st = 0; st < nsteps; ++st) {
    // stage (st + 2) % 3 was read in the previous step, which every thread
    // has left (the barrier at its end)
    const int nx = st + NSTG - 1, cur = st % NSTG;
    if (threadIdx.x == 0 && nx < nsteps) load(nx % NSTG, r_begin + nx * KR);
    if constexpr (D::F32) {
      // the products of step st (h split beforehand) while the block
      // splits step st + 1's h into the other buffer; one barrier a step
      const uint32_t base = smem_u32(hl + (st & 1) * 2 * D::B_PART);
      uint32_t ah[KR / 8][4], al[KR / 8][4];
#pragma unroll
      for (int kk = 0; kk < KR / 8; ++kk) {
        split_tf32(dpe(cur, 8 * kk + t, jr), ah[kk][0], al[kk][0]);
        split_tf32(dpe(cur, 8 * kk + t, jr + 8), ah[kk][1], al[kk][1]);
        split_tf32(dpe(cur, 8 * kk + t + 4, jr), ah[kk][2], al[kk][2]);
        split_tf32(dpe(cur, 8 * kk + t + 4, jr + 8), ah[kk][3], al[kk][3]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KR / 8; ++kk) {
        const uint64_t dh = desc_k(base + 2 * kk * LBO, LBO, 128);
        const uint64_t dl = desc_k(base + D::B_PART + 2 * kk * LBO, LBO, 128);
        wgmma_tf32(acc, al[kk], dh);
        wgmma_tf32(acc, ah[kk], dl);
        wgmma_tf32(acc, ah[kk], dh);
      }
      wg_commit();
      if (st + 1 < nsteps) split_h(st + 1);
    } else {
      mbar_wait(&full[cur], (st / NSTG) & 1);
      // dp = d1 + d2 + d3 in bf16, three products with the bf16 h as staged:
      // N-major, two atoms of 64 columns KR * 128 bytes apart, k step kk
      // 16 rows (2048 bytes) on
      uint32_t p1[KR / 16][4], p2[KR / 16][4], p3[KR / 16][4];
#pragma unroll
      for (int kk = 0; kk < KR / 16; ++kk) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = jr + 8 * (u & 1), k = 16 * kk + 8 * (u >> 1) + 2 * t;
          const float xs[2] = {dpe(cur, k, j), dpe(cur, k + 1, j)};
          __nv_bfloat16 h1[2], h2[2], h3[2];
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            h1[v] = __float2bfloat16_rn(xs[v]);
            const float r1 = __fsub_rn(xs[v], __bfloat162float(h1[v]));
            h2[v] = __float2bfloat16_rn(r1);
            h3[v] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(h2[v])));
          }
          p1[kk][u] = pack_bf16(h1[0], h1[1]);
          p2[kk][u] = pack_bf16(h2[0], h2[1]);
          p3[kk][u] = pack_bf16(h3[0], h3[1]);
        }
      }
      const uint32_t hb = smem_u32(smem + cur * D::STAGE);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KR / 16; ++kk) {
        const uint64_t dd = desc_mn128(hb + kk * 2048, KR * 128);
        wgmma_bf16_tb(acc, p3[kk], dd);
        wgmma_bf16_tb(acc, p2[kk], dd);
        wgmma_bf16_tb(acc, p1[kk], dd);
      }
      wg_commit();
    }
    wg_wait<0>();
    fence_acc(acc);
    __syncthreads();  // every thread is done with the stage (and its hl buffer)
  }
  // acc holds dW^T[j][i]: write dW[i][j]
#pragma unroll
  for (int jj = 0; jj < NTB; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[(size_t)(i0 + 8 * jj + 2 * t + (e & 1)) * HC + j0 + jr + 8 * (e >> 1)] = acc[jj][e];
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <typename T, int MODE>
int launch_rows(const RowArgs<T>& A, cudaStream_t s) {
  const int tile = MODE == ROW_LN0 || MODE == ROW_LN1 ? 32 : WD_TM;
  const dim3 grid((A.M + tile - 1) / tile, A.R);
  if (A.HC <= 1024)
    wide_rows_kernel<T, MODE, 1><<<grid, WD_ROW_THREADS, 0, s>>>(A);
  else
    wide_rows_kernel<T, MODE, 2><<<grid, WD_ROW_THREADS, 0, s>>>(A);
  return (int)cudaGetLastError();
}

template <typename T>
int rows_entry(int mode, const void* agg, const void* gy, const void* seed, const void* g0,
               const void* b0, const void* g1, const void* b1, void* zb, void* pz, void* dp,
               void* out, void* part, int M, int WP, int HC, int H, int L, int R, int relu,
               cudaStream_t s) {
  RowArgs<T> A;
  A.agg = static_cast<const T*>(agg);
  A.gy = static_cast<const T*>(gy);
  A.seed = static_cast<const float*>(seed);
  A.g0 = static_cast<const float*>(g0);
  A.b0 = static_cast<const float*>(b0);
  A.g1 = static_cast<const float*>(g1);
  A.b1 = static_cast<const float*>(b1);
  A.zb = static_cast<T*>(zb);
  A.pz = static_cast<float*>(pz);
  A.dp = static_cast<float*>(dp);
  A.out = static_cast<T*>(out);
  A.part = static_cast<float*>(part);
  A.M = M, A.WP = WP, A.HC = HC, A.H = H, A.L = L, A.R = R, A.relu = relu;
  switch (mode) {
    case ROW_LN0: return launch_rows<T, ROW_LN0>(A, s);
    case ROW_LN1: return launch_rows<T, ROW_LN1>(A, s);
    case ROW_LN1_BWD: return launch_rows<T, ROW_LN1_BWD>(A, s);
    case ROW_LN0_BWD: return launch_rows<T, ROW_LN0_BWD>(A, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TA, typename T>
int gemm_entry(int mode, const void* Ap, const void* B, const void* bias, void* h, void* out,
               void* part, int M, int HC, int L, int l, int q, int R, cudaStream_t s) {
  using P = GemmPlan<TA>;
  GemmArgs<TA, T> g;
  g.A = static_cast<const TA*>(Ap);
  g.B = static_cast<const char*>(B);
  g.bias = static_cast<const float*>(bias);
  g.h = static_cast<T*>(h);
  g.out = static_cast<float*>(out);
  g.part = static_cast<float*>(part);
  g.M = M, g.HC = HC, g.L = L, g.l = l, g.mode = mode, g.q = q;
  cudaError_t e = cudaFuncSetAttribute(wide_gemm_kernel<TA, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, P::bytes);
  if (e != cudaSuccess) return (int)e;
  const int nti = (HC / WD_TN + P::TPI - 1) / P::TPI;
  const long long nitems = (long long)R * ((M + WD_TM - 1) / WD_TM) * nti;
  const int sms = sm_count();
  const int grid = (int)(nitems < sms ? nitems : sms);
  wide_gemm_kernel<TA, T><<<grid, WD_GEMM_THREADS, P::bytes, s>>>(g, R);
  return (int)cudaGetLastError();
}

template <typename T>
int dw_entry(const void* h, const void* dp, void* part_w, int M, int HC, int L, int l, int R,
             int nch, int chunk_rows, cudaStream_t s) {
  using D = DwPlan<T>;
  cudaError_t e = cudaFuncSetAttribute(wide_dw_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, D::bytes);
  if (e != cudaSuccess) return (int)e;
  const unsigned nt = HC / 128;
  wide_dw_kernel<T><<<(unsigned)R * nch * nt * nt, 256, D::bytes, s>>>(
      static_cast<const T*>(h), static_cast<const float*>(dp), M, HC, L, l, nch, chunk_rows,
      static_cast<float*>(part_w));
  return (int)cudaGetLastError();
}

bool wide_shape_ok(int M, int HC, int L, int R) {
  return M > 0 && R > 0 && HC > 512 && HC <= WD_MAX_HC && HC % 128 == 0 && L >= 1 && L <= 2;
}

}  // namespace

extern "C" {

// The row phases (mode: 0 LN0, 1 LN1, 2 LN1's backward, 3 LN0's backward)
// of the wide route. agg [M, R WP], gy [M, R HC] and out (y [M, R HC] or
// dagg [M, R WP]) in the activation dtype (dtype 0 f32, 1 bf16); seed, g0,
// b0, g1, b1 [R, HC] f32; zb [R, Mp, HC] in the dtype and dp [R, Mp, HC]
// f32, tiled (tab; Mp = M rounded up to 128); pz [R, M, HC] f32; part [R,
// ceil(M / 128), 8, HC] f32.
int allset_pma_wide_rows(int mode, const void* agg, const void* gy, const void* seed,
                         const void* g0, const void* b0, const void* g1, const void* b1,
                         void* zb, void* pz, void* dp, void* out, void* part, int M, int WP,
                         int HC, int H, int L, int R, int relu, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (!wide_shape_ok(M, HC, L, R) || H < 1 || HC % H != 0 || WP < HC + H || WP % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return rows_entry<float>(mode, agg, gy, seed, g0, b0, g1, b1, zb, pz, dp, out, part, M, WP,
                             HC, H, L, R, relu, s);
  return rows_entry<__nv_bfloat16>(mode, agg, gy, seed, g0, b0, g1, b1, zb, pz, dp, out, part,
                                   M, WP, HC, H, L, R, relu, s);
}

// One product of the wide route on every (run, 128-row, 128-column) tile:
// A [R, Mp, HC] tiled (the activation dtype for modes 0, 1 (EP_H, EP_V: the
// forward, B = wide_fwd_weights' slabs); f32 for modes 2, 3 (EP_DP, EP_DZ:
// dp @ W^T, B = wide_bwd_weights' slabs)), layer l of L; bias [R, L, HC];
// h [R, Mp, HC] tiled in the dtype; out [R, M, HC] f32 (EP_DP: [R, Mp,
// HC] tiled); part as the row phases'.
int allset_pma_wide_gemm(int mode, const void* A, const void* B, const void* bias, void* h,
                         void* out, void* part, int M, int HC, int L, int l, int q, int R,
                         int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (!wide_shape_ok(M, HC, L, R) || l < 0 || l >= L || mode < EP_H || mode > EP_DZ)
    return (int)cudaErrorInvalidValue;
  const bool fwd = mode == EP_H || mode == EP_V;
  if (dtype == 0)
    return gemm_entry<float, float>(mode, A, B, bias, h, out, part, M, HC, L, l, q, R, s);
  if (fwd)
    return gemm_entry<__nv_bfloat16, __nv_bfloat16>(mode, A, B, bias, h, out, part, M, HC, L, l,
                                                    q, R, s);
  return gemm_entry<float, __nv_bfloat16>(mode, A, B, bias, h, out, part, M, HC, L, l, q, R, s);
}

// dW partials of layer l: part_w [R, nch, L, HC, HC] f32, chunk ch over
// rows [ch chunk_rows, min(M, (ch + 1) chunk_rows)), from h [R, Mp, HC]
// in the dtype and dp [R, Mp, HC] f32, both tiled.
int allset_pma_wide_dw(const void* h, const void* dp, void* part_w, int M, int HC, int L, int l,
                       int R, int nch, int chunk_rows, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (!wide_shape_ok(M, HC, L, R) || l < 0 || l >= L || nch < 1 || chunk_rows % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dw_entry<float>(h, dp, part_w, M, HC, L, l, R, nch, chunk_rows, s);
  return dw_entry<__nv_bfloat16>(h, dp, part_w, M, HC, L, l, R, nch, chunk_rows, s);
}

// K3c on the wide route's partials: dW [R, L, HC, HC] over part_w's nch
// chunks, dsmall [R, 8, HC] over part_s's np row tiles, both in order.
int allset_pma_wide_reduce(const void* part_w, int nch, void* dW, const void* part_s, int np,
                           void* dsmall, int HC, int L, int R, void* stream) {
  return (int)launch_reduce(static_cast<const float*>(part_w), nch, L * HC * HC,
                            static_cast<float*>(dW), static_cast<const float*>(part_s), np,
                            8 * HC, static_cast<float*>(dsmall), R,
                            reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
