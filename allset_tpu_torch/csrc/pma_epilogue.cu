// K2 / K3: the fused PMA epilogue, forward and backward.
//
// Replaces allset_tpu/ops/pallas_pma.py::_fwd_kernel (K2) and ::_bwd_kernel
// (K3), and their runs grids (K2R, K3R: the R > 1 pallas_calls of
// _pallas_fwd/_pallas_bwd). Per row of the packed aggregate
// agg = [vals HC | den H | pad]:
//   out0 = vals / expand(max(den, 1e-16)) + seed
//   z    = LN0(out0)            f32, fast variance E[x^2] - mu^2, eps 1e-5
//   zb   = z rounded to the activation dtype
//   p_l  = round(round(h_l @ W_l) + b_l)   L in {1, 2}; h_0 = zb,
//          h_1 = round(relu(p_0))          (TorchDense rounding points)
//   y    = LN1(zb + relu(p_L-1)), rounded, optionally relu'd
// Every op is row-local except the rFF product, so one 16-row tile is
// computed per block with all intermediates in shared memory.
//
// What bounds it on the H100: at hidden 256 the forward reads the
// [M, WP] aggregate once and writes [M, HC] once (bytes), and runs
// 2*L*HC^2 flops per row. The design keeps every intermediate on chip
// (one read, one write per row), takes the bf16 products on the tensor
// cores (WMMA 16x16x16, f32 accumulation) and the f32 products as full-f32
// FMA (no TF32), and reads the small [HC, HC] weights from L2.
//
// The backward (K3) recomputes the forward per tile (nothing is stored by
// K2), then writes dagg = [dvals | dden | 0] in the activation dtype. The
// parameter gradients are reduced without atomics, so they are repeatable
// bit for bit:
//   * K3a, one block per tile (grid-strided): row-local backward; the
//     small-vector grads (dseed, dg0, db0, dg1, db1, dbrff) are summed per
//     block into f32 partials [G, 8, HC]; the rFF layer inputs and their
//     output gradients are written out for the dW product;
//   * K3b: dW partials [NCH, L, HC, HC] = h_l^T dp_l over row chunks, f32;
//   * K3c: a second kernel sums each partial table over its first axis
//     in a fixed order.
// Runs (K2R/K3R): R statistical runs folded into the width. agg is
// [M, R*WP] with run r in columns [r*WP, (r+1)*WP), y [M, R*HC], the
// parameters carry a leading [R] axis, dW is [R, L, HC, HC] and dsmall
// [R, 8, HC]. The second grid axis runs over r; a block offsets its
// pointers to its run and reads rows with the folded stride, so the body
// is K2/K3's and run r's outputs equal a single-run launch on run r's
// slice bit for bit (same tiles, same partials, same reduce order). R = 1
// is the single-run layout.
// Shapes: HC % 64 == 0, HC <= 256, H divides HC, WP >= HC + H.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int ROWS = 16;        // rows per tile: one WMMA M tile
constexpr int THREADS = 256;    // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int RPW = ROWS / NWARPS;  // rows per warp in the row-wise phases
constexpr float EPS = 1e-5f;
constexpr float DEN_FLOOR = 1e-16f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared-memory layout, in this order (the forward uses the first part):
//   x0, p0, p1, x1      f32 [ROWS][HC]   xhat0, rFF outputs, xhat1 / dz
//   hb0, hb1            T   [ROWS][HC+8] zb, round(relu(p0))
//   rstd0, rstd1        f32 [ROWS]
//   g, dh               f32 [ROWS][HC]   backward only
__host__ __device__ inline size_t smem_bytes(int HC, int tsize, bool bwd) {
  size_t f = (size_t)ROWS * HC * 4;
  size_t b = 4 * f + 2 * (size_t)ROWS * (HC + 8) * tsize + 2 * ROWS * 4;
  return bwd ? b + 2 * f : b;
}

template <typename T>
struct Smem {
  float *x0, *p0, *p1, *x1, *rstd0, *rstd1, *g, *dh;
  T *hb0, *hb1;
  __device__ Smem(char* base, int HC) {
    const size_t f = (size_t)ROWS * HC;
    float* fp = reinterpret_cast<float*>(base);
    x0 = fp;
    p0 = fp + f;
    p1 = fp + 2 * f;
    x1 = fp + 3 * f;
    hb0 = reinterpret_cast<T*>(fp + 4 * f);
    hb1 = hb0 + (size_t)ROWS * (HC + 8);
    rstd0 = reinterpret_cast<float*>(hb1 + (size_t)ROWS * (HC + 8));
    rstd1 = rstd0 + ROWS;
    g = rstd1 + ROWS;
    dh = g + f;
  }
};

// C[ROWS][N] (f32, smem) = A[ROWS][K] (smem, row stride lda) @ B[K][N] (global)

// f32: one thread per output column, full-f32 FMA over K (no TF32).
__device__ void gemm_tile(const float* A, int lda, const float* __restrict__ B,
                          int K, int N, float* C) {
  for (int c = threadIdx.x; c < N; c += THREADS) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float b = B[(size_t)k * N + c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(A[r * lda + k], b, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) C[r * N + c] = acc[r];
  }
}

// bf16: tensor cores through WMMA, f32 accumulation; each warp owns
// 16-column output tiles.
__device__ void gemm_tile(const __nv_bfloat16* A, int lda,
                          const __nv_bfloat16* __restrict__ B, int K, int N,
                          float* C) {
  const int warp = threadIdx.x >> 5;
  for (int nt = warp; nt < N / 16; nt += NWARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kt = 0; kt < K / 16; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, A + kt * 16, lda);
      wmma::load_matrix_sync(b, B + (size_t)kt * 16 * N + nt * 16, N);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + nt * 16, acc, N, wmma::mem_row_major);
  }
}

// Forward chain of one tile (pallas_pma.py::_fwd_recompute). Leaves
// xhat0/rstd0, zb, p_l, h_1, xhat1/rstd1 in shared memory. Phase 3 is
// row-wise by warp: a caller that reads x1 in the same warp-row mapping
// needs no barrier.
template <typename T>
__device__ void fwd_tile(const T* __restrict__ agg, int M, size_t lda, int HC, int H,
                         int L, int row0, const float* __restrict__ seed,
                         const float* __restrict__ g0, const float* __restrict__ b0,
                         const T* __restrict__ Wc, const float* __restrict__ brff,
                         Smem<T>& s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = HC / H, HCP = HC + 8;
  // 1. divide + seed residual + LN0
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    const int grow = row0 + r;
    const bool valid = grow < M;
    const T* a = agg + grow * lda;
    float sum = 0.f, sq = 0.f;
    for (int c = lane; c < HC; c += 32) {
      const float v = valid ? to_f(a[c]) : 0.f;
      const float den = valid ? to_f(a[HC + c / C]) : 0.f;
      const float x = v * (1.f / fmaxf(den, DEN_FLOOR)) + seed[c];
      s.x0[r * HC + c] = x;
      sum += x;
      sq += x * x;
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mu = sum / HC;
    const float rstd = rsqrtf(sq / HC - mu * mu + EPS);
    for (int c = lane; c < HC; c += 32) {
      const float xh = (s.x0[r * HC + c] - mu) * rstd;
      s.x0[r * HC + c] = xh;
      s.hb0[r * HCP + c] = from_f<T>(xh * g0[c] + b0[c]);
    }
    if (lane == 0) s.rstd0[r] = rstd;
  }
  __syncthreads();
  // 2. rFF with TorchDense rounding
  for (int l = 0; l < L; ++l) {
    float* p = l == 0 ? s.p0 : s.p1;
    gemm_tile(l == 0 ? s.hb0 : s.hb1, HCP, Wc + (size_t)l * HC * HC, HC, HC, p);
    __syncthreads();
    for (int i = threadIdx.x; i < ROWS * HC; i += THREADS) {
      const int r = i / HC, c = i % HC;
      const float v = round_to<T>(round_to<T>(p[i]) + brff[l * HC + c]);
      p[i] = v;
      if (l < L - 1) s.hb1[r * HCP + c] = from_f<T>(fmaxf(v, 0.f));
    }
    __syncthreads();
  }
  // 3. relu residual + LN1 statistics
  const float* pl = L == 1 ? s.p0 : s.p1;
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    float sum = 0.f, sq = 0.f;
    for (int c = lane; c < HC; c += 32) {
      const float o = to_f(s.hb0[r * HCP + c]) + fmaxf(pl[r * HC + c], 0.f);
      s.x1[r * HC + c] = o;
      sum += o;
      sq += o * o;
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mu = sum / HC;
    const float rstd = rsqrtf(sq / HC - mu * mu + EPS);
    for (int c = lane; c < HC; c += 32) s.x1[r * HC + c] = (s.x1[r * HC + c] - mu) * rstd;
    if (lane == 0) s.rstd1[r] = rstd;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pma_fwd_kernel(const T* __restrict__ agg, const float* __restrict__ seed,
               const float* __restrict__ g0, const float* __restrict__ b0,
               const T* __restrict__ Wc, const float* __restrict__ brff,
               const float* __restrict__ g1, const float* __restrict__ b1,
               T* __restrict__ out, int M, int WP, int HC, int H, int L, int relu) {
  extern __shared__ __align__(128) char smem[];
  Smem<T> s(smem, HC);
  // this block's run (blockIdx.y) of R = gridDim.y folded runs
  const int run = blockIdx.y, R = gridDim.y;
  const size_t lda = (size_t)R * WP, ldo = (size_t)R * HC;
  agg += (size_t)run * WP;
  out += (size_t)run * HC;
  seed += (size_t)run * HC, g0 += (size_t)run * HC, b0 += (size_t)run * HC;
  g1 += (size_t)run * HC, b1 += (size_t)run * HC;
  Wc += (size_t)run * L * HC * HC;
  brff += (size_t)run * L * HC;
  const int row0 = blockIdx.x * ROWS;
  fwd_tile<T>(agg, M, lda, HC, H, L, row0, seed, g0, b0, Wc, brff, s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    const int grow = row0 + r;
    if (grow >= M) continue;
    for (int c = lane; c < HC; c += 32) {
      T y = from_f<T>(s.x1[r * HC + c] * g1[c] + b1[c]);
      if (relu && !(to_f(y) > 0.f)) y = from_f<T>(0.f);
      out[grow * ldo + c] = y;
    }
  }
}

// K3a: row-local backward of one tile per iteration (pallas_pma.py:204-256).
template <typename T>
__global__ void __launch_bounds__(THREADS)
pma_bwd_rows_kernel(const T* __restrict__ agg, const T* __restrict__ gy,
                    const float* __restrict__ seed, const float* __restrict__ g0,
                    const float* __restrict__ b0, const T* __restrict__ Wc,
                    const float* __restrict__ WT, const float* __restrict__ brff,
                    const float* __restrict__ g1, const float* __restrict__ b1,
                    T* __restrict__ dagg, T* __restrict__ hin,
                    float* __restrict__ dpbuf, float* __restrict__ part_small,
                    int M, int WP, int HC, int H, int L, int relu) {
  extern __shared__ __align__(128) char smem[];
  Smem<T> s(smem, HC);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = HC / H, HCP = HC + 8, npad = WP - HC - H;
  // this block's run (blockIdx.y) of R = gridDim.y folded runs
  const int run = blockIdx.y, R = gridDim.y;
  const size_t lda = (size_t)R * WP, ldg = (size_t)R * HC;
  agg += (size_t)run * WP;
  dagg += (size_t)run * WP;
  gy += (size_t)run * HC;
  seed += (size_t)run * HC, g0 += (size_t)run * HC, b0 += (size_t)run * HC;
  g1 += (size_t)run * HC, b1 += (size_t)run * HC;
  Wc += (size_t)run * L * HC * HC;
  WT += (size_t)run * L * HC * HC;
  brff += (size_t)run * L * HC;
  hin += (size_t)run * L * M * HC;
  dpbuf += (size_t)run * L * M * HC;
  part_small += (size_t)run * gridDim.x * 8 * HC;
  // this thread's column partials: dseed, dg0, db0, dg1, db1, dbrff[0..2]
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  const int ntiles = (M + ROWS - 1) / ROWS;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int row0 = t * ROWS;
    fwd_tile<T>(agg, M, lda, HC, H, L, row0, seed, g0, b0, Wc, brff, s);
    const float* pl = L == 1 ? s.p0 : s.p1;
    // upstream gradient; the folded relu masks on the ROUNDED output
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      const int grow = row0 + r;
      const bool valid = grow < M;
      for (int c = lane; c < HC; c += 32) {
        float gv = valid ? to_f(gy[grow * ldg + c]) : 0.f;
        if (relu) {
          const float y = round_to<T>(s.x1[r * HC + c] * g1[c] + b1[c]);
          gv = gv * (y > 0.f ? 1.f : 0.f);
        }
        s.g[r * HC + c] = gv;
      }
    }
    __syncthreads();
    if (tid < HC) {  // dg1, db1
      float a = 0.f, b = 0.f;
      for (int r = 0; r < ROWS; ++r) {
        const float gv = s.g[r * HC + tid];
        a += gv * s.x1[r * HC + tid];
        b += gv;
      }
      acc[3] += a;
      acc[4] += b;
    }
    __syncthreads();
    // LN1 backward: x1 <- dz = dout2; g <- dp = dout2 * (p_last > 0)
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < HC; c += 32) {
        const float gg = s.g[r * HC + c] * g1[c];
        s1 += gg;
        s2 += gg * s.x1[r * HC + c];
      }
      s1 = warp_sum(s1) / HC;
      s2 = warp_sum(s2) / HC;
      const float rstd = s.rstd1[r];
      for (int c = lane; c < HC; c += 32) {
        const int i = r * HC + c;
        const float d = rstd * (s.g[i] * g1[c] - s1 - s.x1[i] * s2);
        s.x1[i] = d;
        s.g[i] = d * (pl[i] > 0.f ? 1.f : 0.f);
      }
    }
    __syncthreads();
    // rFF backward, last layer first
    for (int l = L - 1; l >= 0; --l) {
      const T* hsrc = l == 0 ? s.hb0 : s.hb1;
      if (tid < HC) {
        float b = 0.f;
        for (int r = 0; r < ROWS; ++r) b += s.g[r * HC + tid];
        acc[5 + l] += b;
      }
      for (int i = tid; i < ROWS * HC; i += THREADS) {
        const int r = i / HC, c = i % HC;
        const int grow = row0 + r;
        if (grow < M) {
          const size_t o = ((size_t)l * M + grow) * HC + c;
          hin[o] = hsrc[r * HCP + c];
          dpbuf[o] = s.g[i];
        }
      }
      gemm_tile(s.g, HC, WT + (size_t)l * HC * HC, HC, HC, s.dh);  // dp @ W^T
      __syncthreads();
      for (int i = tid; i < ROWS * HC; i += THREADS) {
        if (l > 0)
          s.g[i] = s.dh[i] * (s.p0[i] > 0.f ? 1.f : 0.f);
        else
          s.x1[i] += s.dh[i];
      }
      __syncthreads();
    }
    if (tid < HC) {  // dg0, db0
      float a = 0.f, b = 0.f;
      for (int r = 0; r < ROWS; ++r) {
        const float dz = s.x1[r * HC + tid];
        a += dz * s.x0[r * HC + tid];
        b += dz;
      }
      acc[1] += a;
      acc[2] += b;
    }
    __syncthreads();
    // LN0 backward -> dout0 (g); dvals -> dagg; dout0 * vals -> dh
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      const int grow = row0 + r;
      const bool valid = grow < M;
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < HC; c += 32) {
        const float gg = s.x1[r * HC + c] * g0[c];
        s1 += gg;
        s2 += gg * s.x0[r * HC + c];
      }
      s1 = warp_sum(s1) / HC;
      s2 = warp_sum(s2) / HC;
      const float rstd = s.rstd0[r];
      const T* a = agg + grow * lda;
      for (int c = lane; c < HC; c += 32) {
        const int i = r * HC + c;
        const float d0 = rstd * (s.x1[i] * g0[c] - s1 - s.x0[i] * s2);
        s.g[i] = d0;
        const float v = valid ? to_f(a[c]) : 0.f;
        const float den = valid ? to_f(a[HC + c / C]) : 0.f;
        s.dh[i] = d0 * v;
        if (valid) dagg[grow * lda + c] = from_f<T>(d0 * (1.f / fmaxf(den, DEN_FLOOR)));
      }
    }
    __syncthreads();
    if (tid < HC) {  // dseed
      float b = 0.f;
      for (int r = 0; r < ROWS; ++r) b += s.g[r * HC + tid];
      acc[0] += b;
    }
    for (int i = tid; i < ROWS * H; i += THREADS) {  // dden, per (row, head)
      const int r = i / H, h = i % H;
      const int grow = row0 + r;
      if (grow >= M) continue;
      float sm = 0.f;
      for (int c = h * C; c < (h + 1) * C; ++c) sm += s.dh[r * HC + c];
      const float den = to_f(agg[grow * lda + HC + h]);
      const float dinv = 1.f / fmaxf(den, DEN_FLOOR);
      const float dd = den > DEN_FLOOR ? -sm * (dinv * dinv) : 0.f;
      dagg[grow * lda + HC + h] = from_f<T>(dd);
    }
    for (int i = tid; i < ROWS * npad; i += THREADS) {  // zero pad columns
      const int r = i / npad, c = HC + H + i % npad;
      const int grow = row0 + r;
      if (grow < M) dagg[grow * lda + c] = from_f<T>(0.f);
    }
    __syncthreads();
  }
  if (tid < HC) {
#pragma unroll
    for (int k = 0; k < 8; ++k) part_small[((size_t)blockIdx.x * 8 + k) * HC + tid] = acc[k];
  }
}

// K3b: part[run][ch][l] = hin[run][l][rows of ch]^T @ dp[run][l][rows of ch],
// 64x64 tiles; blockIdx.z = (run * nch + ch) * L + l.
template <typename T>
__global__ void __launch_bounds__(256)
dw_partial_kernel(const T* __restrict__ hin, const float* __restrict__ dp, int M,
                  int HC, int L, int nch, int chunk_rows, float* __restrict__ part) {
  __shared__ float As[32][64];
  __shared__ float Bs[32][64];
  const int j0 = blockIdx.x * 64, i0 = blockIdx.y * 64;
  const int run = blockIdx.z / (nch * L);
  const int ch = blockIdx.z % (nch * L) / L, l = blockIdx.z % L;
  hin += (size_t)run * L * M * HC;
  dp += (size_t)run * L * M * HC;
  part += (size_t)run * nch * L * HC * HC;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
  const int r_begin = ch * chunk_rows;
  const int r_end = min(M, r_begin + chunk_rows);
  for (int r0 = r_begin; r0 < r_end; r0 += 32) {
    for (int e = threadIdx.x; e < 32 * 64; e += 256) {
      const int rr = e / 64, cc = e % 64, r = r0 + rr;
      const size_t o = ((size_t)l * M + r) * HC;
      As[rr][cc] = r < r_end ? to_f(hin[o + i0 + cc]) : 0.f;
      Bs[rr][cc] = r < r_end ? dp[o + j0 + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < 32; ++rr) {
      float a[4], b[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) a[x] = As[rr][ty * 4 + x];
#pragma unroll
      for (int y = 0; y < 4; ++y) b[y] = Bs[rr][tx * 4 + y];
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
    }
    __syncthreads();
  }
  float* outp = part + ((size_t)ch * L + l) * HC * HC;
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y)
      outp[(size_t)(i0 + ty * 4 + x) * HC + j0 + tx * 4 + y] = acc[x][y];
}

// K3c: out[run][j] = sum_p part[run][p][j], in order of p (run = blockIdx.y).
__global__ void reduce_partials_kernel(const float* __restrict__ part, int P,
                                       int N, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  part += (size_t)blockIdx.y * P * N;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += part[(size_t)p * N + j];
  out[(size_t)blockIdx.y * N + j] = s;
}

template <typename T>
int launch_fwd(const void* agg, const void* seed, const void* g0, const void* b0,
               const void* Wc, const void* brff, const void* g1, const void* b1,
               void* out, int M, int WP, int HC, int H, int L, int R, int relu,
               cudaStream_t s) {
  const size_t bytes = smem_bytes(HC, sizeof(T), false);
  cudaError_t e = cudaFuncSetAttribute(
      pma_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  pma_fwd_kernel<T><<<dim3((M + ROWS - 1) / ROWS, R), THREADS, bytes, s>>>(
      (const T*)agg, (const float*)seed, (const float*)g0, (const float*)b0,
      (const T*)Wc, (const float*)brff, (const float*)g1, (const float*)b1,
      (T*)out, M, WP, HC, H, L, relu);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* agg, const void* gy, const void* seed, const void* g0,
               const void* b0, const void* Wc, const void* WT, const void* brff,
               const void* g1, const void* b1, void* dagg, void* dW, void* dsmall,
               void* hin, void* dpbuf, void* part_small, void* part_w, int M,
               int WP, int HC, int H, int L, int R, int relu, int grid_rows, int nch,
               int chunk_rows, cudaStream_t s) {
  const size_t bytes = smem_bytes(HC, sizeof(T), true);
  cudaError_t e = cudaFuncSetAttribute(
      pma_bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  pma_bwd_rows_kernel<T><<<dim3(grid_rows, R), THREADS, bytes, s>>>(
      (const T*)agg, (const T*)gy, (const float*)seed, (const float*)g0,
      (const float*)b0, (const T*)Wc, (const float*)WT, (const float*)brff,
      (const float*)g1, (const float*)b1, (T*)dagg, (T*)hin, (float*)dpbuf,
      (float*)part_small, M, WP, HC, H, L, relu);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dw_partial_kernel<T><<<dim3(HC / 64, HC / 64, R * nch * L), 256, 0, s>>>(
      (const T*)hin, (const float*)dpbuf, M, HC, L, nch, chunk_rows, (float*)part_w);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int nw = L * HC * HC, ns = 8 * HC;
  reduce_partials_kernel<<<dim3((nw + 255) / 256, R), 256, 0, s>>>(
      (const float*)part_w, nch, nw, (float*)dW);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  reduce_partials_kernel<<<dim3((ns + 255) / 256, R), 256, 0, s>>>(
      (const float*)part_small, grid_rows, ns, (float*)dsmall);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (agg, out, Wc). Parameters are float32.
// R runs folded into the width (R = 1: the single-run layout); WP is the
// per-run width.
int allset_pma_epilogue_fwd(const void* agg, const void* seed, const void* g0,
                            const void* b0, const void* Wc, const void* brff,
                            const void* g1, const void* b1, void* out, int M,
                            int WP, int HC, int H, int L, int R, int relu,
                            int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || R <= 0) return (int)cudaGetLastError();
  if (dtype == 0)
    return launch_fwd<float>(agg, seed, g0, b0, Wc, brff, g1, b1, out, M, WP, HC,
                             H, L, R, relu, s);
  return launch_fwd<__nv_bfloat16>(agg, seed, g0, b0, Wc, brff, g1, b1, out, M,
                                   WP, HC, H, L, R, relu, s);
}

// Scratch (allocated by the caller), per run: hin [R, L, M, HC] dtype,
// dpbuf [R, L, M, HC] f32, part_small [R, grid_rows, 8, HC] f32,
// part_w [R, nch, L, HC, HC] f32.
int allset_pma_epilogue_bwd(const void* agg, const void* gy, const void* seed,
                            const void* g0, const void* b0, const void* Wc,
                            const void* WT, const void* brff, const void* g1,
                            const void* b1, void* dagg, void* dW, void* dsmall,
                            void* hin, void* dpbuf, void* part_small,
                            void* part_w, int M, int WP, int HC, int H, int L,
                            int R, int relu, int dtype, int grid_rows, int nch,
                            int chunk_rows, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || R <= 0) return (int)cudaGetLastError();
  if (dtype == 0)
    return launch_bwd<float>(agg, gy, seed, g0, b0, Wc, WT, brff, g1, b1, dagg, dW,
                             dsmall, hin, dpbuf, part_small, part_w, M, WP, HC, H,
                             L, R, relu, grid_rows, nch, chunk_rows, s);
  return launch_bwd<__nv_bfloat16>(agg, gy, seed, g0, b0, Wc, WT, brff, g1, b1,
                                   dagg, dW, dsmall, hin, dpbuf, part_small,
                                   part_w, M, WP, HC, H, L, R, relu, grid_rows, nch,
                                   chunk_rows, s);
}

}  // extern "C"
