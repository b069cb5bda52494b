// K2/K3 and K2R/K3R at widths above 512: the fused PMA epilogue's forward
// and backward (allset_tpu/ops/pallas_pma.py::_fwd_kernel and _bwd_kernel,
// their R = 1 and R > 1 grids) at a width HC given at run time, a multiple
// of 128 (640 ... 2048), which the tiled kernels of pma_epilogue.cuh do not
// take: their per-warp register tiles and shared-memory slabs are sized
// for HC <= 512.
//
// Bound on the H100 by the rFF products, like the narrower kernels; this
// pair is the simple one: products in f32 FMA on the CUDA cores (bf16
// operands rounded as TorchDense rounds them, f32 accumulation), not on the
// tensor cores, and intermediates in global scratch, so any width runs with
// the same code and the same registers.
//   * A block of 256 threads takes tiles of TR = 16 rows of one run
//     (blockIdx.y), a fixed grid of G blocks striding over the tiles, so
//     the order of every sum depends on M alone: run r of a folded launch
//     equals a launch on run r's slice bit for bit.
//   * Row phases (LayerNorms, rounding, masks, the denominators) run a
//     warp per row; the per-tile [TR, HC] intermediates live in the
//     block's slice of a global scratch (L1 and L2 keep them close), read
//     back after a barrier.
//   * Products of a [TR, HC] tile with a [HC, HC] weight: a thread per
//     output column, TR accumulators, k ascending (four k per step, the
//     tile's values read as float4 broadcasts, the weight column coalesced
//     across the threads).
//   * The backward keeps each layer's input and output gradient for all
//     rows (hin, dp: [R, L, M, HC] f32) and forms dW = hin^T dp in a
//     second kernel (64 x 64 output tiles, rows in ascending order); the
//     small vectors (dseed, dg0, db0, dg1, db1, dbrff) are summed per block
//     in row order by the thread owning each column, then over the blocks
//     in block order by a third kernel. No atomics: deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256, NWARPS = 8, TR = 16;
constexpr int NBUF = 10;  // [TR, HC] f32 tile buffers per block
constexpr float EPS = 1e-5f, DEN_FLOOR = 1e-16f;
enum { X0, ZB, H1, P0, P1, O2, DZ, DH, D0, DPB };

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
struct Args {
  const T* agg;
  const T* gy;
  const float *seed, *g0, *b0, *Wf, *WT, *brff, *g1, *b1;
  T* out;  // y (forward) or dagg (backward)
  float *hin, *dp, *tile, *part;
  int M, WP, HC, H, L, R, relu, G;
};

// out[i][c] = sum_k A[i][k] * B[k][c] for the TR rows of a tile, k ascending
__device__ __forceinline__ void tile_gemm(const float* A, const float* B, float* out, int HC) {
  for (int c = threadIdx.x; c < HC; c += THREADS) {
    float acc[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) acc[i] = 0.f;
    for (int k = 0; k < HC; k += 4) {
      const float w0 = B[(size_t)k * HC + c], w1 = B[(size_t)(k + 1) * HC + c];
      const float w2 = B[(size_t)(k + 2) * HC + c], w3 = B[(size_t)(k + 3) * HC + c];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(A + (size_t)i * HC + k);
        acc[i] = fmaf(a.x, w0, acc[i]);
        acc[i] = fmaf(a.y, w1, acc[i]);
        acc[i] = fmaf(a.z, w2, acc[i]);
        acc[i] = fmaf(a.w, w3, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) out[(size_t)i * HC + c] = acc[i];
  }
}

// The forward of one tile up to the rFF outputs: buffers X0 (out0), ZB
// (zb), P0/P1 (the rounded rFF outputs), H1 (the second layer's input), the
// row statistics of LN0 in mu0/rs0. Rows past M are zeros.
template <typename T>
__device__ void fwd_tile(const Args<T>& A, int r, int row0, float* buf, float* mu0,
                         float* rs0) {
  const int HC = A.HC, C = HC / A.H, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t lda = (size_t)A.R * A.WP;
  for (int i = warp; i < TR; i += NWARPS) {
    const int m = row0 + i;
    float* x0 = buf + (size_t)X0 * TR * HC + (size_t)i * HC;
    float* zb = buf + (size_t)ZB * TR * HC + (size_t)i * HC;
    if (m >= A.M) {
      for (int c = lane; c < HC; c += 32) x0[c] = zb[c] = 0.f;
      if (lane == 0) mu0[i] = rs0[i] = 0.f;
      continue;
    }
    const T* a = A.agg + (size_t)m * lda + (size_t)r * A.WP;
    const float* seed = A.seed + (size_t)r * HC;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < HC; c += 32) {
      const float inv = 1.f / fmaxf(ld(a + HC + c / C), DEN_FLOOR);
      const float v = ld(a + c) * inv + seed[c];
      x0[c] = v;
      s += v;
      s2 += v * v;
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / HC, rs = rsqrtf(s2 / HC - mu * mu + EPS);
    const float *g0 = A.g0 + (size_t)r * HC, *b0 = A.b0 + (size_t)r * HC;
    for (int c = lane; c < HC; c += 32) zb[c] = rnd<T>((x0[c] - mu) * rs * g0[c] + b0[c]);
    if (lane == 0) {
      mu0[i] = mu;
      rs0[i] = rs;
    }
  }
  __syncthreads();
  for (int l = 0; l < A.L; ++l) {
    float* p = buf + (size_t)(P0 + l) * TR * HC;
    tile_gemm(buf + (size_t)(l == 0 ? ZB : H1) * TR * HC,
              A.Wf + ((size_t)r * A.L + l) * HC * HC, p, HC);
    __syncthreads();
    const float* bias = A.brff + ((size_t)r * A.L + l) * HC;
    for (int i = warp; i < TR; i += NWARPS) {
      for (int c = lane; c < HC; c += 32) {
        const float v = rnd<T>(rnd<T>(p[(size_t)i * HC + c]) + bias[c]);
        p[(size_t)i * HC + c] = v;
        if (l + 1 < A.L) buf[(size_t)H1 * TR * HC + (size_t)i * HC + c] = rnd<T>(fmaxf(v, 0.f));
      }
    }
    __syncthreads();
  }
}

// LN1's input out2 = zb + relu(p_last) into O2 for row i; returns (mu1, rstd1)
template <typename T>
__device__ __forceinline__ float2 out2_row(const Args<T>& A, float* buf, int i) {
  const int HC = A.HC, lane = threadIdx.x & 31;
  const float* zb = buf + (size_t)ZB * TR * HC + (size_t)i * HC;
  const float* p = buf + (size_t)(P0 + A.L - 1) * TR * HC + (size_t)i * HC;
  float* o2 = buf + (size_t)O2 * TR * HC + (size_t)i * HC;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < HC; c += 32) {
    const float v = zb[c] + fmaxf(p[c], 0.f);
    o2[c] = v;
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / HC;
  return make_float2(mu, rsqrtf(s2 / HC - mu * mu + EPS));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) wide_fwd(Args<T> A) {
  __shared__ float mu0[TR], rs0[TR];
  const int r = blockIdx.y, HC = A.HC, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* buf = A.tile + ((size_t)r * A.G + blockIdx.x) * NBUF * TR * HC;
  const float *g1 = A.g1 + (size_t)r * HC, *b1 = A.b1 + (size_t)r * HC;
  for (int row0 = blockIdx.x * TR; row0 < A.M; row0 += A.G * TR) {
    fwd_tile(A, r, row0, buf, mu0, rs0);
    for (int i = warp; i < TR; i += NWARPS) {
      const int m = row0 + i;
      if (m >= A.M) continue;
      const float2 st1 = out2_row(A, buf, i);
      const float* o2 = buf + (size_t)O2 * TR * HC + (size_t)i * HC;
      T* y = A.out + (size_t)m * A.R * HC + (size_t)r * HC;
      for (int c = lane; c < HC; c += 32) {
        float v = rnd<T>((o2[c] - st1.x) * st1.y * g1[c] + b1[c]);
        if (A.relu) v = fmaxf(v, 0.f);
        st(y + c, v);
      }
    }
    __syncthreads();
  }
}

// part[q][c] (the block's partial of small vector q) += rows of a tile
__device__ __forceinline__ float* part_of(float* part, int q, int HC) {
  return part + (size_t)q * HC;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) wide_bwd_rows(Args<T> A) {
  __shared__ float mu0[TR], rs0[TR], mu1[TR], rs1[TR];
  const int r = blockIdx.y, HC = A.HC, L = A.L, C = HC / A.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* buf = A.tile + ((size_t)r * A.G + blockIdx.x) * NBUF * TR * HC;
  float* part = A.part + ((size_t)r * A.G + blockIdx.x) * 8 * HC;
  for (int j = threadIdx.x; j < 8 * HC; j += THREADS) part[j] = 0.f;
  const float *g0 = A.g0 + (size_t)r * HC, *g1 = A.g1 + (size_t)r * HC;
  const float* b1 = A.b1 + (size_t)r * HC;
  const size_t lda = (size_t)A.R * A.WP, ldy = (size_t)A.R * HC;
  auto tb = [buf, HC](int k, int i) { return buf + (size_t)k * TR * HC + (size_t)i * HC; };
  for (int row0 = blockIdx.x * TR; row0 < A.M; row0 += A.G * TR) {
    const int nvalid = min(TR, A.M - row0);
    fwd_tile(A, r, row0, buf, mu0, rs0);
    // the layer inputs and (below) output gradients of the valid rows, for dW
    for (int l = 0; l < L; ++l) {
      const float* src = tb(l == 0 ? ZB : H1, 0);
      float* dst = A.hin + (((size_t)r * L + l) * A.M + row0) * HC;
      for (int j = threadIdx.x; j < nvalid * HC; j += THREADS) dst[j] = src[j];
    }
    // LN1 backward, the relu mask, dp of the last layer
    for (int i = warp; i < TR; i += NWARPS) {
      const int m = row0 + i;
      float *dz = tb(DZ, i), *gyb = tb(DH, i), *dpl = tb(DPB, i);
      if (m >= A.M) {
        for (int c = lane; c < HC; c += 32) dz[c] = gyb[c] = dpl[c] = 0.f;
        continue;
      }
      const float2 st1 = out2_row(A, buf, i);
      const float* o2 = tb(O2, i);
      const T* gy = A.gy + (size_t)m * ldy + (size_t)r * HC;
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < HC; c += 32) {
        const float xh = (o2[c] - st1.x) * st1.y;
        float g = ld(gy + c);
        if (A.relu && !(rnd<T>(xh * g1[c] + b1[c]) > 0.f)) g = 0.f;
        gyb[c] = g;
        const float gg = g * g1[c];
        s1 += gg;
        s2 += gg * xh;
      }
      s1 = warp_sum(s1) / HC;
      s2 = warp_sum(s2) / HC;
      const float* pl = tb(P0 + L - 1, i);
      for (int c = lane; c < HC; c += 32) {
        const float xh = (o2[c] - st1.x) * st1.y;
        const float d = st1.y * (gyb[c] * g1[c] - s1 - xh * s2);
        dz[c] = d;
        dpl[c] = pl[c] > 0.f ? d : 0.f;
      }
      if (lane == 0) {
        mu1[i] = st1.x;
        rs1[i] = st1.y;
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < HC; c += THREADS) {
      for (int i = 0; i < nvalid; ++i) {
        const float g = tb(DH, i)[c], xh = (tb(O2, i)[c] - mu1[i]) * rs1[i];
        part_of(part, 3, HC)[c] += g * xh;
        part_of(part, 4, HC)[c] += g;
      }
    }
    // through the rFF, last layer first
    for (int l = L - 1; l >= 0; --l) {
      {
        float* dst = A.dp + (((size_t)r * L + l) * A.M + row0) * HC;
        const float* src = tb(DPB, 0);
        for (int j = threadIdx.x; j < nvalid * HC; j += THREADS) dst[j] = src[j];
      }
      for (int c = threadIdx.x; c < HC; c += THREADS)
        for (int i = 0; i < nvalid; ++i) part_of(part, 5 + l, HC)[c] += tb(DPB, i)[c];
      __syncthreads();
      tile_gemm(tb(DPB, 0), A.WT + ((size_t)r * L + l) * HC * HC, tb(DH, 0), HC);
      __syncthreads();
      for (int i = warp; i < TR; i += NWARPS) {
        float *dh = tb(DH, i), *dpl = tb(DPB, i), *dz = tb(DZ, i);
        const float* pprev = tb(P0 + (l > 0 ? l - 1 : 0), i);
        for (int c = lane; c < HC; c += 32) {
          if (l > 0)
            dpl[c] = pprev[c] > 0.f ? dh[c] : 0.f;
          else
            dz[c] += dh[c];
        }
      }
      __syncthreads();
    }
    // LN0 backward, then dagg = [dv | dden | 0]
    for (int i = warp; i < TR; i += NWARPS) {
      const int m = row0 + i;
      if (m >= A.M) continue;
      const float *x0 = tb(X0, i), *dz = tb(DZ, i);
      float* d0 = tb(D0, i);
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < HC; c += 32) {
        const float xh = (x0[c] - mu0[i]) * rs0[i], gg = dz[c] * g0[c];
        s1 += gg;
        s2 += gg * xh;
      }
      s1 = warp_sum(s1) / HC;
      s2 = warp_sum(s2) / HC;
      const T* a = A.agg + (size_t)m * lda + (size_t)r * A.WP;
      T* da = A.out + (size_t)m * lda + (size_t)r * A.WP;
      for (int c = lane; c < HC; c += 32) {
        const float xh = (x0[c] - mu0[i]) * rs0[i];
        const float d = rs0[i] * (dz[c] * g0[c] - s1 - xh * s2);
        d0[c] = d;
        st(da + c, d * (1.f / fmaxf(ld(a + HC + c / C), DEN_FLOOR)));
      }
      __syncwarp();
      for (int h = lane; h < A.H; h += 32) {
        const float den = ld(a + HC + h), inv = 1.f / fmaxf(den, DEN_FLOOR);
        float s = 0.f;
        for (int c = h * C; c < (h + 1) * C; ++c) s += d0[c] * ld(a + c);
        st(da + HC + h, den > DEN_FLOOR ? -s * (inv * inv) : 0.f);
      }
      for (int c = HC + A.H + lane; c < A.WP; c += 32) st(da + c, 0.f);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < HC; c += THREADS) {
      for (int i = 0; i < nvalid; ++i) {
        const float dz = tb(DZ, i)[c], xh = (tb(X0, i)[c] - mu0[i]) * rs0[i];
        part_of(part, 0, HC)[c] += tb(D0, i)[c];
        part_of(part, 1, HC)[c] += dz * xh;
        part_of(part, 2, HC)[c] += dz;
      }
    }
    __syncthreads();
  }
}

// dW[r][l] = hin[r][l]^T dp[r][l] over the M rows, in ascending row order:
// 64 x 64 output tiles, 4 x 4 per thread, rows staged 16 at a time
__global__ void __launch_bounds__(THREADS)
    wide_dw(const float* __restrict__ hin, const float* __restrict__ dp, float* __restrict__ dW,
            int M, int HC) {
  __shared__ float As[16][64], Bs[16][64];
  const int rl = blockIdx.z, i0 = blockIdx.y * 64, j0 = blockIdx.x * 64;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* a = hin + (size_t)rl * M * HC;
  const float* b = dp + (size_t)rl * M * HC;
  float acc[4][4] = {};
  for (int m0 = 0; m0 < M; m0 += 16) {
    for (int j = threadIdx.x; j < 16 * 64; j += THREADS) {
      const int kk = j / 64, c = j % 64, m = m0 + kk;
      As[kk][c] = m < M ? a[(size_t)m * HC + i0 + c] : 0.f;
      Bs[kk][c] = m < M ? b[(size_t)m * HC + j0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[p][q] = fmaf(As[kk][ty * 4 + p], Bs[kk][tx * 4 + q], acc[p][q]);
    }
    __syncthreads();
  }
  float* out = dW + (size_t)rl * HC * HC;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) out[(size_t)(i0 + ty * 4 + p) * HC + j0 + tx * 4 + q] = acc[p][q];
}

// dsmall[r][q][c] = sum over the G blocks, in block order, of part[r][b][q][c]
__global__ void wide_small(const float* __restrict__ part, float* __restrict__ dsmall, int G,
                           int HC) {
  const int r = blockIdx.y;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < 8 * HC; j += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < G; ++b) s += part[((size_t)r * G + b) * 8 * HC + j];
    dsmall[(size_t)r * 8 * HC + j] = s;
  }
}

template <typename T>
Args<T> make_args(const void* agg, const void* gy, const void* seed, const void* g0,
                  const void* b0, const void* Wf, const void* WT, const void* brff,
                  const void* g1, const void* b1, void* out, void* hin, void* dp, void* tile,
                  void* part, int M, int WP, int HC, int H, int L, int R, int relu, int G) {
  Args<T> A;
  A.agg = static_cast<const T*>(agg);
  A.gy = static_cast<const T*>(gy);
  A.seed = static_cast<const float*>(seed);
  A.g0 = static_cast<const float*>(g0);
  A.b0 = static_cast<const float*>(b0);
  A.Wf = static_cast<const float*>(Wf);
  A.WT = static_cast<const float*>(WT);
  A.brff = static_cast<const float*>(brff);
  A.g1 = static_cast<const float*>(g1);
  A.b1 = static_cast<const float*>(b1);
  A.out = static_cast<T*>(out);
  A.hin = static_cast<float*>(hin);
  A.dp = static_cast<float*>(dp);
  A.tile = static_cast<float*>(tile);
  A.part = static_cast<float*>(part);
  A.M = M;
  A.WP = WP;
  A.HC = HC;
  A.H = H;
  A.L = L;
  A.R = R;
  A.relu = relu;
  A.G = G;
  return A;
}

}  // namespace

extern "C" {

// Forward. Wf: [R, L, HC, HC] f32 ([in][out]) holding the weights rounded
// to the activation dtype; tile: [R, G, 10, 16, HC] f32 scratch.
int allset_pma_wide_fwd(const void* agg, const void* seed, const void* g0, const void* b0,
                        const void* Wf, const void* brff, const void* g1, const void* b1,
                        void* y, void* tile, int M, int WP, int HC, int H, int L, int R,
                        int relu, int dtype, int G, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || R <= 0) return (int)cudaGetLastError();
  if (HC % 128 != 0 || HC % H != 0 || L < 1 || L > 2 || G < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(G, R);
  if (dtype == 0)
    wide_fwd<float><<<grid, THREADS, 0, s>>>(make_args<float>(
        agg, nullptr, seed, g0, b0, Wf, nullptr, brff, g1, b1, y, nullptr, nullptr, tile,
        nullptr, M, WP, HC, H, L, R, relu, G));
  else
    wide_fwd<__nv_bfloat16><<<grid, THREADS, 0, s>>>(make_args<__nv_bfloat16>(
        agg, nullptr, seed, g0, b0, Wf, nullptr, brff, g1, b1, y, nullptr, nullptr, tile,
        nullptr, M, WP, HC, H, L, R, relu, G));
  return (int)cudaGetLastError();
}

// Backward. Wf as above, WT: [R, L, HC, HC] f32 ([out][in], not rounded);
// scratch hin, dp: [R, L, M, HC] f32, tile: [R, G, 10, 16, HC] f32, part:
// [R, G, 8, HC] f32. dW: [R, L, HC, HC], dsmall: [R, 8, HC] f32.
int allset_pma_wide_bwd(const void* agg, const void* gy, const void* seed, const void* g0,
                        const void* b0, const void* Wf, const void* WT, const void* brff,
                        const void* g1, const void* b1, void* dagg, void* dW, void* dsmall,
                        void* hin, void* dp, void* tile, void* part, int M, int WP, int HC,
                        int H, int L, int R, int relu, int dtype, int G, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || R <= 0) return (int)cudaGetLastError();
  if (HC % 128 != 0 || HC % H != 0 || L < 1 || L > 2 || G < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(G, R);
  if (dtype == 0)
    wide_bwd_rows<float><<<grid, THREADS, 0, s>>>(make_args<float>(
        agg, gy, seed, g0, b0, Wf, WT, brff, g1, b1, dagg, hin, dp, tile, part, M, WP, HC, H,
        L, R, relu, G));
  else
    wide_bwd_rows<__nv_bfloat16><<<grid, THREADS, 0, s>>>(make_args<__nv_bfloat16>(
        agg, gy, seed, g0, b0, Wf, WT, brff, g1, b1, dagg, hin, dp, tile, part, M, WP, HC, H,
        L, R, relu, G));
  wide_dw<<<dim3(HC / 64, HC / 64, R * L), THREADS, 0, s>>>(
      static_cast<const float*>(hin), static_cast<const float*>(dp), static_cast<float*>(dW), M,
      HC);
  wide_small<<<dim3((8 * HC + THREADS - 1) / THREADS, R), THREADS, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dsmall), G, HC);
  return (int)cudaGetLastError();
}

}  // extern "C"
