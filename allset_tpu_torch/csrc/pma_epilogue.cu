// K3 / K3R: the fused PMA epilogue's backward (pallas_pma.py::_bwd_kernel,
// its R = 1 and R > 1 grids) at HC 64, 128 and 192. The design note is in
// pma_epilogue.cuh; HC 256 runs on pma_epilogue_wg.cu, 384 and 512 on
// pma_epilogue_cluster_bwd.cu.

#include "pma_epilogue.cuh"

namespace {

// K3's shared memory: the A operand [TM][HC + 4] f32 (or [TM][HC + 8] T),
// the row-sum exchange [2][NWARPS][TM], the row statistics mu0, rstd0,
// rstd1 [3][TM], each warp group's column sums [WG][8][HC], the two weight
// stages, and the tile's rows of agg [TM][SW] in T: SW = HC + H rounded up
// to 8 columns, or, with den in global memory (DG), the values alone in SW
// = HC + 8 (its dagg on the way out)
__host__ __device__ constexpr size_t stage_offset(int HC) {
  return (size_t)tm_of(HC) * (HC + 4) * 4 + 2 * NWARPS * tm_of(HC) * 4 + 3 * tm_of(HC) * 4 +
         (size_t)WG * 8 * HC * 4;
}
__host__ __device__ constexpr size_t agg_offset(int HC) {
  return stage_offset(HC) + 2 * slab_bytes(HC, ksf_of(HC, true));
}
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int HC, int SW) {
  return agg_offset(HC) + (size_t)tm_of(HC) * SW * sizeof(T);
}

// Stage rows [row0, row0 + TM) of agg, their first SW columns (HC with
// DG), zeros past M: 16-byte copies by the whole block, one wait, one
// barrier.
template <typename T, int HC, bool DG>
__device__ __forceinline__ void load_agg(const Args<T>& A, int row0, T* sAgg) {
  constexpr int V = 16 / sizeof(T), TM = tm_of(HC);
  const int SW = agg_width<HC, DG>(A.H), nv = (DG ? HC : SW) / V;
  for (int i = threadIdx.x; i < TM * nv; i += THREADS) {
    const int r = i / nv, c = i % nv, grow = row0 + r;
    cp16z(sAgg + r * SW + c * V, A.agg + (size_t)(grow < A.M ? grow : 0) * A.lda + c * V,
          grow < A.M);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();
}

// K3's forward recompute of the tile at row0: its agg rows staged, then
// fwd_chain in K3's layout (the A operand at the start of smem).
template <typename T, int HC, bool DG, int MT = mt_of(HC)>
__device__ __forceinline__ void fwd_tile(const Args<T>& A, int row0, char* smem,
                                         float (&X)[MT][HC / 64][4], float (&P)[MT][HC / 64][4],
                                         uint64_t& pos0, uint64_t& posL) {
  constexpr int TM = tm_of(HC);
  float* red = reinterpret_cast<float*>(smem + (size_t)TM * (HC + 4) * 4);
  T* sAgg = reinterpret_cast<T*>(smem + agg_offset(HC));
  load_agg<T, HC, DG>(A, row0, sAgg);
  fwd_chain<T, HC, true, DG, ksf_of(HC, true)>(A, row0, sAgg, smem, red, red + 2 * NWARPS * TM,
                                               smem + stage_offset(HC), X, P, pos0, posL);
}

template <typename T, int HC>
constexpr bool den_may_overflow() {
  return smem_bytes<T>(HC, agg_width<HC, false>(HC)) > SMEM_MAX;
}

// K3a: row-local backward of one tile per iteration (pallas_pma.py:204-256).
template <typename T, int HC, bool DG>
__global__ void __launch_bounds__(THREADS, 1) pma_bwd_rows_kernel(Args<T> A0) {
  constexpr int NT = HC / 64, MT = mt_of(HC), TM = tm_of(HC);
  extern __shared__ __align__(128) char smem[];
  const Args<T> A = at_run(A0, HC, blockIdx.y);
  const Lane<MT> ln;
  const int n0 = ln.w * (HC / 8), C = HC / A.H, SW = agg_width<HC, DG>(A.H);
  const int W = DG ? HC : SW;  // the staged columns of dagg
  float* sf = reinterpret_cast<float*>(smem);  // the A operand as f32 [TM][HC + 4]
  T* sAgg = reinterpret_cast<T*>(smem + agg_offset(HC));  // the tile's agg, then dagg
  float* red = sf + TM * (HC + 4);
  float* stat = red + 2 * NWARPS * TM;
  // per warp group: dseed, dg0, db0, dg1, db1, dbrff[0..2]
  float* csum0 = stat + 3 * TM;
  float* csum = csum0 + ln.q * 8 * HC;
  for (int i = threadIdx.x; i < WG * 8 * HC; i += THREADS) csum0[i] = 0.f;
  __syncthreads();
  float X[MT][NT][4], P[MT][NT][4];
  float pa[2 * MT], pb[2 * MT];
  const int ntiles = (A.M + TM - 1) / TM;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * TM;
    uint64_t pos0, posL;
    fwd_tile<T, HC, DG>(A, row0, smem, X, P, pos0, posL);
    // 4. upstream gradient (the folded relu masks on the ROUNDED output)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int grow = row0 + ln.row(m, 2 * h);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = n0 + 8 * j + 2 * ln.t;
          const float2 gv = grow < A.M ? load2(A.gy + (size_t)grow * A.ldg + c)
                                       : make_float2(0.f, 0.f);
          P[m][j][2 * h] = gv.x;
          P[m][j][2 * h + 1] = gv.y;
          if (A.relu) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float y = round_to<T>(
                  __fadd_rn(__fmul_rn(X[m][j][2 * h + q], A.g1[c + q]), A.b1[c + q]));
              if (!(y > 0.f)) P[m][j][2 * h + q] = 0.f;
            }
          }
        }
      }
    col_add<MT, NT>([&](int m, int j, int e) { return P[m][j][e] * X[m][j][e]; }, csum + 3 * HC,
                n0, ln);  // dg1
    col_add<MT, NT>([&](int m, int j, int e) { return P[m][j][e]; }, csum + 4 * HC, n0, ln);
    // LN1 backward: P <- dz = dout2; X <- dp = dout2 * (p_L-1 > 0)
#pragma unroll
    for (int i = 0; i < 2 * MT; ++i) pa[i] = pb[i] = 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float gg = P[m][j][e] * A.g1[n0 + 8 * j + 2 * ln.t + (e & 1)];
          pa[2 * m + (e >> 1)] += gg;
          pb[2 * m + (e >> 1)] += gg * X[m][j][e];
        }
    row_reduce(pa, pb, red, ln);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 2 * m + (e >> 1);
          const float rstd = stat[2 * TM + ln.row(m, e)];
          const float gg = P[m][j][e] * A.g1[n0 + 8 * j + 2 * ln.t + (e & 1)];
          const float d = rstd * (gg - pa[i] / HC - X[m][j][e] * (pb[i] / HC));
          P[m][j][e] = d;
          X[m][j][e] = (posL >> ((m * NT + j) * 4 + e)) & 1 ? d : 0.f;
        }
    // 5. rFF backward, last layer first: X = dp_l
    for (int l = A.L - 1; l >= 0; --l) {
      col_add<MT, NT>([&](int m, int j, int e) { return X[m][j][e]; }, csum + (5 + l) * HC, n0, ln);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int grow = row0 + ln.row(m, 2 * h);
          if (grow >= A.M) continue;
#pragma unroll
          for (int j = 0; j < NT; ++j)
            store2(A.dpbuf + ((size_t)l * A.M + grow) * HC + n0 + 8 * j + 2 * ln.t,
                   X[m][j][2 * h], X[m][j][2 * h + 1]);
        }
      __syncthreads();  // every warp is done with the previous A operand
      put_a<float, HC, NT>(X, smem, n0, ln);
      __syncthreads();
      // dh = dp_l @ W_l^T: B[k][n] = W_l[n][k]
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) X[m][j][e] = 0.f;
      gemm_f32<HC, NT, false, ksf_of(HC, true)>(sf, HC + 4, A.Wf + (size_t)l * HC * HC,
                                                smem + stage_offset(HC), n0, ln, X);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (l > 0) {
              if (!((pos0 >> ((m * NT + j) * 4 + e)) & 1)) X[m][j][e] = 0.f;
            } else {
              P[m][j][e] += X[m][j][e];
            }
          }
    }
    // 6. LN0 backward (xhat0 recomputed into X) -> dout0 in P
#pragma unroll
    for (int i = 0; i < 2 * MT; ++i) pa[i] = pb[i] = 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = ln.row(m, e), c = n0 + 8 * j + 2 * ln.t + (e & 1);
          float v, dinv;
          const float x = out0_at<T, HC, DG>(A, sAgg, row0, r, c, v, dinv);
          const float xh = __fmul_rn(__fsub_rn(x, stat[r]), stat[TM + r]);
          X[m][j][e] = xh;
          const float gg = P[m][j][e] * A.g0[c];
          pa[2 * m + (e >> 1)] += gg;
          pb[2 * m + (e >> 1)] += gg * xh;
        }
    col_add<MT, NT>([&](int m, int j, int e) { return P[m][j][e] * X[m][j][e]; }, csum + HC, n0,
                ln);  // dg0
    col_add<MT, NT>([&](int m, int j, int e) { return P[m][j][e]; }, csum + 2 * HC, n0, ln);
    row_reduce(pa, pb, red, ln);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 2 * m + (e >> 1), r = ln.row(m, e);
          const float gg = P[m][j][e] * A.g0[n0 + 8 * j + 2 * ln.t + (e & 1)];
          P[m][j][e] = stat[TM + r] * (gg - pa[i] / HC - X[m][j][e] * (pb[i] / HC));
        }
    col_add<MT, NT>([&](int m, int j, int e) { return P[m][j][e]; }, csum, n0, ln);  // dseed
    // dvals over the staged vals; dout0 * vals -> the A buffer for the
    // per-head dden sums; then dden over den and zeros in the pad columns,
    // into the stage (or, past its W columns, straight out), and the
    // tile's dagg rows out, 16 bytes at a time
    __syncthreads();  // every warp is done with the last product's A operand
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ln.row(m, 2 * h);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = n0 + 8 * j + 2 * ln.t;
          float d[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float v, dinv;
            out0_at<T, HC, DG>(A, sAgg, row0, r, c + q, v, dinv);
            const float d0 = P[m][j][2 * h + q];
            d[q] = d0 * dinv;
            sf[r * (HC + 4) + c + q] = d0 * v;
          }
          store2(sAgg + r * SW + c, d[0], d[1]);
        }
      }
    __syncthreads();
    const int NP = A.WP - HC;
    for (int i = threadIdx.x; i < TM * NP; i += THREADS) {  // per (row, head or pad)
      const int r = i / NP, h = i % NP;
      float dd = 0.f;
      if (h < A.H) {
        float sm = 0.f;
        for (int c = h * C; c < (h + 1) * C; ++c) sm += sf[r * (HC + 4) + c];
        const float den = den_at<T, HC, DG>(A, sAgg, row0, r, h);
        const float dinv = 1.f / fmaxf(den, DEN_FLOOR);
        dd = den > DEN_FLOOR ? -sm * (dinv * dinv) : 0.f;
      }
      if (HC + h < W)
        sAgg[r * SW + HC + h] = from_f<T>(dd);
      else if (row0 + r < A.M)
        A.out[(size_t)(row0 + r) * A.lda + HC + h] = from_f<T>(dd);
    }
    __syncthreads();
    store_tile(A, row0, TM, sAgg, SW, W, A.out, A.lda);
    __syncthreads();
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * HC; i += THREADS) {  // the groups' tables in order
    float v = csum0[i];
    for (int q = 1; q < WG; ++q) v += csum0[q * 8 * HC + i];
    A.part_small[(size_t)blockIdx.x * 8 * HC + i] = v;
  }
}

// K3b: part[run][ch][l] = hin[run][l][rows of ch]^T @ dp[run][l][rows of ch]
// on a BT x BT output tile (BT = 128 where it divides HC, else 64); blockIdx.x =
// (((run * nch + ch) * L + l) * nt + ti) * nt + tj with nt = HC / BT, so
// the tiles of one chunk run side by side and share its rows in L2. 8
// warps, each (BT / 2) x (BT / 4) of the tile; the rows come in steps of
// 32, copied with cp.async into one of two stages while the warps multiply
// with the other (rows past the chunk are zero-filled).
constexpr int DW_THREADS = 256;

template <typename T, int BT>
__host__ __device__ constexpr size_t dw_smem_bytes() {
  return (size_t)2 * 32 * (BT + 8) * (sizeof(T) + 4);
}

template <typename T, int BT>
__global__ void __launch_bounds__(DW_THREADS)
dw_partial_kernel(const T* __restrict__ hin, const float* __restrict__ dp, int M, int HC,
                  int L, int nch, int chunk_rows, float* __restrict__ part) {
  constexpr int LD = BT + 8;       // conflict-free fragment reads
  constexpr int XT = BT / 32;      // m16 tiles of a warp along i
  constexpr int YT = BT / 32;      // n8 tiles of a warp along j
  constexpr int VA = 16 / sizeof(T), VB = 4;  // elements per 16-byte copy
  extern __shared__ __align__(16) char smem[];
  T* As = reinterpret_cast<T*>(smem);                                     // [2][32][LD]
  float* Bs = reinterpret_cast<float*>(smem + 2 * 32 * LD * sizeof(T));  // [2][32][LD]
  const int nt = HC / BT;
  int b = blockIdx.x;
  const int tj = b % nt;
  b /= nt;
  const int ti = b % nt;
  b /= nt;
  const int l = b % L;
  b /= L;
  const int ch = b % nch, run = b / nch;
  const int i0 = ti * BT, j0 = tj * BT;
  hin += ((size_t)run * L + l) * M * HC;
  dp += ((size_t)run * L + l) * M * HC;
  part += (((size_t)run * nch + ch) * L + l) * HC * HC;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
  const int wi = (warp >> 2) * (BT / 2), wj = (warp & 3) * (BT / 4);
  float acc[XT][YT][4];
#pragma unroll
  for (int x = 0; x < XT; ++x)
#pragma unroll
    for (int y = 0; y < YT; ++y)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[x][y][e] = 0.f;
  const int r_begin = ch * chunk_rows;
  const int r_end = min(M, r_begin + chunk_rows);
  const int nsteps = (r_end - r_begin + 31) / 32;
  auto load = [&](int st, int r0) {
    T* a = As + st * 32 * LD;
    float* bb = Bs + st * 32 * LD;
    for (int i = threadIdx.x; i < 32 * (BT / VA); i += DW_THREADS) {
      const int rr = i / (BT / VA), c = i % (BT / VA), r = r0 + rr;
      cp16z(a + rr * LD + c * VA, hin + (size_t)(r < r_end ? r : r_begin) * HC + i0 + c * VA,
            r < r_end);
    }
    for (int i = threadIdx.x; i < 32 * (BT / VB); i += DW_THREADS) {
      const int rr = i / (BT / VB), c = i % (BT / VB), r = r0 + rr;
      cp16z(bb + rr * LD + c * VB, dp + (size_t)(r < r_end ? r : r_begin) * HC + j0 + c * VB,
            r < r_end);
    }
  };
  if (nsteps > 0) {
    load(0, r_begin);
    cp_commit();
  }
#pragma unroll 1
  for (int st = 0; st < nsteps; ++st) {
    if (st + 1 < nsteps) {
      load((st + 1) & 1, r_begin + 32 * (st + 1));
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* a = As + (st & 1) * 32 * LD;
    const float* bb = Bs + (st & 1) * 32 * LD;
#pragma unroll
    for (int kk = 0; kk < 32; kk += 8) {
      uint32_t bh[YT][2], bl[YT][2];
#pragma unroll
      for (int y = 0; y < YT; ++y) {
        split_tf32(bb[(kk + t) * LD + wj + 8 * y + g], bh[y][0], bl[y][0]);
        split_tf32(bb[(kk + t + 4) * LD + wj + 8 * y + g], bh[y][1], bl[y][1]);
      }
#pragma unroll
      for (int x = 0; x < XT; ++x) {
        const int im = wi + 16 * x + g;
        const float av[4] = {to_f(a[(kk + t) * LD + im]), to_f(a[(kk + t) * LD + im + 8]),
                             to_f(a[(kk + t + 4) * LD + im]),
                             to_f(a[(kk + t + 4) * LD + im + 8])};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(av[q], ah[q], al[q]);
#pragma unroll
        for (int y = 0; y < YT; ++y) {
          if (sizeof(T) == 4) mma_tf32(acc[x][y], al, bh[y]);  // bf16 h: al == 0
          mma_tf32(acc[x][y], ah, bl[y]);
          mma_tf32(acc[x][y], ah, bh[y]);
        }
      }
    }
    __syncthreads();  // this stage is refilled in the next iteration
  }
#pragma unroll
  for (int x = 0; x < XT; ++x)
#pragma unroll
    for (int y = 0; y < YT; ++y)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + wi + 16 * x + g + 8 * h, j = j0 + wj + 8 * y + 2 * t;
        store2(part + (size_t)i * HC + j, acc[x][y][2 * h], acc[x][y][2 * h + 1]);
      }
}

template <typename T, int HC, bool DG>
int launch_bwd_rows(const Args<T>& A, int R, int grid_rows, cudaStream_t s) {
  const size_t bytes = smem_bytes<T>(HC, agg_width<HC, DG>(A.H));
  cudaError_t e = cudaFuncSetAttribute(pma_bwd_rows_kernel<T, HC, DG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  pma_bwd_rows_kernel<T, HC, DG><<<dim3(grid_rows, R), THREADS, bytes, s>>>(A);
  return (int)cudaGetLastError();
}

// parts: which of K3a (1), K3b (2) and K3c (4) to launch (7 = all; the
// others time one part on scratch a full launch has filled)
template <typename T, int HC>
int launch_bwd(const Args<T>& A, int R, float* dW, float* dsmall, float* part_w,
               int grid_rows, int nch, int chunk_rows, int parts, cudaStream_t s) {
  int rc = (int)cudaSuccess;
  if (parts & 1) {
    if constexpr (den_may_overflow<T, HC>())
      rc = smem_bytes<T>(HC, agg_width<HC, false>(A.H)) > SMEM_MAX
               ? launch_bwd_rows<T, HC, true>(A, R, grid_rows, s)
               : launch_bwd_rows<T, HC, false>(A, R, grid_rows, s);
    else
      rc = launch_bwd_rows<T, HC, false>(A, R, grid_rows, s);
  }
  if (rc != (int)cudaSuccess) return rc;
  cudaError_t e;
  if (parts & 2) {
    constexpr int BT = HC % 128 == 0 ? 128 : 64;
    constexpr size_t dw_bytes = dw_smem_bytes<T, BT>();
    e = cudaFuncSetAttribute(dw_partial_kernel<T, BT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dw_bytes);
    if (e != cudaSuccess) return (int)e;
    const int nt = HC / BT;
    dw_partial_kernel<T, BT><<<(unsigned)R * nch * A.L * nt * nt, DW_THREADS, dw_bytes, s>>>(
        A.hin, A.dpbuf, A.M, HC, A.L, nch, chunk_rows, part_w);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (!(parts & 4)) return (int)cudaSuccess;
  return (int)launch_reduce(part_w, nch, A.L * HC * HC, dW, A.part_small, grid_rows, 8 * HC,
                            dsmall, R, s);
}

}  // namespace

extern "C" {

// Scratch (allocated by the caller), per run: hin [R, L, M, HC] dtype,
// dpbuf [R, L, M, HC] f32, part_small [R, grid_rows, 8, HC] f32,
// part_w [R, nch, L, HC, HC] f32.
int allset_pma_epilogue_bwd(const void* agg, const void* gy, const void* seed,
                            const void* g0, const void* b0, const void* Wf,
                            const void* Wbt, const void* brff, const void* g1,
                            const void* b1, void* dagg, void* dW, void* dsmall,
                            void* hin, void* dpbuf, void* part_small,
                            void* part_w, int M, int WP, int HC, int H, int L,
                            int R, int relu, int dtype, int grid_rows, int nch,
                            int chunk_rows, int parts, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || R <= 0) return (int)cudaGetLastError();
#define BWD(T, HCV)                                                                         \
  if (HC == HCV)                                                                            \
    return launch_bwd<T, HCV>(make_args<T>(agg, gy, seed, g0, b0, Wf, Wbt, brff, g1, b1,   \
                                           dagg, hin, dpbuf, part_small, M, WP, HC, H, L, \
                                           R, relu),                                       \
                              R, static_cast<float*>(dW), static_cast<float*>(dsmall),     \
                              static_cast<float*>(part_w), grid_rows, nch, chunk_rows, parts, s);
  // HC 256 runs on the warpgroup kernels (pma_epilogue_wg.cu), 384 and
  // 512 on the cluster kernel (pma_epilogue_cluster_bwd.cu)
  if (dtype == 0) {
    BWD(float, 64) BWD(float, 128) BWD(float, 192)
  } else {
    BWD(__nv_bfloat16, 64) BWD(__nv_bfloat16, 128) BWD(__nv_bfloat16, 192)
  }
#undef BWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
