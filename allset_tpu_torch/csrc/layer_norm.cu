// B12 / B13: the model's LayerNorm, forward and backward.
//
// Replaces benchmarks/exp_ln.py::_fwd_kernel (B12) and ::_bwd_kernel (B13),
// put on the path of the system: every 'ln' NormLayer of the port (the Deep
// Sets MLPs f_enc / f_dec with their input norms, the classifier's and
// gpr_mlp's hidden norms) runs here on the card. It computes the model's
// LayerNorm (flax nn.LayerNorm as allset_tpu/nn/modules.py::NormLayer uses
// it), not the experiment's two-pass variance. Per row x of F elements:
//   mu = mean(x), var = max(mean(x^2) - mu^2, 0)   f32, the fast variance
//   rstd = rsqrt(var + 1e-5)
//   y = (x - mu) * (rstd * gamma) + beta           in the output type
// backward (B13's one-pass form), with xh = (x - mu) * rstd, gg = g * gamma:
//   dx = rstd * (gg - mean(gg) - xh * mean(gg * xh))
//   dgamma = sum over rows of g * xh, dbeta = sum over rows of g.
// The plain versions are allset_tpu_torch/ops/cuda_ln.py::ln_fwd_plain and
// ln_bwd_plain.
//
// What bounds them on the H100: bytes. The forward reads x once and writes y
// once (4 B per element in bf16); the backward reads g and x and writes dx
// (6 B per element), and F f32 partials per block of rows. The design is the
// simple one: one warp per row (any F), lane l owning the 4-element chunks
// at 4l + 128k, loaded as one vector where the row is aligned, element by
// element otherwise (the same order of additions either way); the row's
// sums are per-lane sums folded by a fixed xor butterfly. The passes over a
// row re-read it (from L1/L2) instead of holding it in registers, so no F
// is refused.
// dgamma / dbeta: each backward block of BWD_ROWS rows writes one f32
// partial per column (its rows summed in row order, after the row pass,
// from the same mu and rstd); a second kernel sums a column's partials in
// fixed block order. No atomics: the bits repeat run to run.
// Runs (the statistical runs folded into one launch): x is [rows, R, F] (or
// one [rows, F] shared by all runs: run stride 0), gamma and beta [R, F], y
// and dx [rows, R, F], the partials [R, blocks, F]. A row of run r is
// computed by the same code on the same values as in a launch on run r
// alone, and run r's partials cover the same row blocks, so run r's outputs
// equal that launch's bit for bit. R = 1 is the single-run layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BWD_ROWS = 64;  // rows per backward block (one partial each)
constexpr float EPS = 1e-5f;

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

// elements c .. c+3 of a row; out-of-range elements read as 0. vec: F % 4
// == 0 and the row 4-element aligned, so the chunk is in range and one load.
__device__ __forceinline__ void load4(const float* row, int c, int F, bool vec, float v[4]) {
  if (vec) {
    const float4 q = *reinterpret_cast<const float4*>(row + c);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = c + j < F ? row[c + j] : 0.f;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* row, int c, int F, bool vec,
                                      float v[4]) {
  if (vec) {
    const uint2 q = *reinterpret_cast<const uint2*>(row + c);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(a); v[1] = __high2float(a);
    v[2] = __low2float(b); v[3] = __high2float(b);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = c + j < F ? __bfloat162float(row[c + j]) : 0.f;
}

__device__ __forceinline__ void store4(float* row, int c, int F, bool vec, const float v[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < F) row[c + j] = v[j];
}

__device__ __forceinline__ void store4(__nv_bfloat16* row, int c, int F, bool vec,
                                       const float v[4]) {
  if (vec) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<uint32_t*>(&a);
    q.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(row + c) = q;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < F) row[c + j] = __float2bfloat16_rn(v[j]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// mu and rstd of one row, in the lane order described above (forward and
// backward share it, so both see the same bits)
template <typename T>
__device__ __forceinline__ void row_stats(const T* xr, int F, bool vec, int lane, float& mu,
                                          float& rstd) {
  float s = 0.f, s2 = 0.f;
  for (int c = 4 * lane; c < F; c += 128) {
    float v[4];
    load4(xr, c, F, vec, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s += v[j];
      s2 += v[j] * v[j];
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  mu = s / (float)F;
  const float var = fmaxf(s2 / (float)F - mu * mu, 0.f);
  rstd = rsqrtf(var + EPS);
}

// one warp per (row, run) item; item q = i * R + r is y's row q
template <typename Ti, typename To>
__global__ void __launch_bounds__(THREADS)
ln_fwd_kernel(const Ti* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, To* __restrict__ y, long long rows, int R,
              int F, long long xs_row, long long xs_run, bool vec_x, bool vec_y) {
  const long long q = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (q >= rows * R) return;
  const int lane = threadIdx.x % 32;
  const long long i = q / R;
  const int r = (int)(q - i * R);
  const Ti* xr = x + i * xs_row + r * xs_run;
  const float* g = gamma + (long long)r * F;
  const float* b = beta + (long long)r * F;
  To* yr = y + q * F;
  float mu, rstd;
  row_stats(xr, F, vec_x, lane, mu, rstd);
  for (int c = 4 * lane; c < F; c += 128) {
    float v[4], o[4];
    load4(xr, c, F, vec_x, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = c + j < F ? (v[j] - mu) * (rstd * g[c + j]) + b[c + j] : 0.f;
    store4(yr, c, F, vec_y, o);
  }
}

// block (b, r): rows [b * BWD_ROWS, ...) of run r. Row pass: one warp per
// row writes dx (in y's layout) and keeps the row's mu and rstd; column
// pass: thread per column sums its g * xh and g over the block's rows in
// row order into the block's partials [R, blocks, F].
template <typename Tx, typename Tg>
__global__ void __launch_bounds__(THREADS)
ln_bwd_kernel(const Tg* __restrict__ gy, const Tx* __restrict__ x,
              const float* __restrict__ gamma, Tx* __restrict__ dx,
              float* __restrict__ part_g, float* __restrict__ part_b, long long rows, int R,
              int F, long long xs_row, long long xs_run, bool vec_x, bool vec_g) {
  __shared__ float s_mu[BWD_ROWS];
  __shared__ float s_rstd[BWD_ROWS];
  const int r = blockIdx.y;
  const long long blk = blockIdx.x;
  const long long row0 = blk * BWD_ROWS;
  const int nr = (int)min((long long)BWD_ROWS, rows - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* gam = gamma + (long long)r * F;
  for (int k = warp; k < nr; k += WARPS) {
    const long long i = row0 + k;
    const Tx* xr = x + i * xs_row + r * xs_run;
    const Tg* gr = gy + (i * R + r) * F;
    float mu, rstd;
    row_stats(xr, F, vec_x, lane, mu, rstd);
    float a1 = 0.f, a2 = 0.f;
    for (int c = 4 * lane; c < F; c += 128) {
      float xv[4], gv[4];
      load4(xr, c, F, vec_x, xv);
      load4(gr, c, F, vec_g, gv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c + j < F) {
          const float gg = gv[j] * gam[c + j];
          const float xh = (xv[j] - mu) * rstd;
          a1 += gg;
          a2 += gg * xh;
        }
      }
    }
    const float m1 = warp_sum(a1) / (float)F;
    const float m2 = warp_sum(a2) / (float)F;
    if (dx != nullptr) {
      Tx* dr = dx + (i * R + r) * F;
      for (int c = 4 * lane; c < F; c += 128) {
        float xv[4], gv[4], o[4];
        load4(xr, c, F, vec_x, xv);
        load4(gr, c, F, vec_g, gv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float gg = c + j < F ? gv[j] * gam[c + j] : 0.f;
          const float xh = (xv[j] - mu) * rstd;
          o[j] = rstd * (gg - m1 - xh * m2);
        }
        store4(dr, c, F, vec_x, o);
      }
    }
    if (lane == 0) {
      s_mu[k] = mu;
      s_rstd[k] = rstd;
    }
  }
  __syncthreads();
  const long long out = ((long long)r * gridDim.x + blk) * F;
  for (int c = threadIdx.x; c < F; c += THREADS) {
    float ag = 0.f, ab = 0.f;
    for (int k = 0; k < nr; ++k) {
      const long long i = row0 + k;
      const float gv = to_f(gy[(i * R + r) * F + c]);
      const float xh = (to_f(x[i * xs_row + r * xs_run + c]) - s_mu[k]) * s_rstd[k];
      ag += gv * xh;
      ab += gv;
    }
    part_g[out + c] = ag;
    part_b[out + c] = ab;
  }
}

// dgamma[r, c], dbeta[r, c]: block (column tile of 32, run r); lane = column,
// warp w sums blocks w, w + 8, ... in order, then warp 0 adds the 8 sums in
// warp order.
__global__ void __launch_bounds__(THREADS)
ln_bwd_reduce_kernel(const float* __restrict__ part_g, const float* __restrict__ part_b,
                     float* __restrict__ dgamma, float* __restrict__ dbeta, int nblk, int F) {
  __shared__ float sg[WARPS][32];
  __shared__ float sb[WARPS][32];
  const int r = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  float ag = 0.f, ab = 0.f;
  if (c < F) {
    for (int b = warp; b < nblk; b += WARPS) {
      const long long o = ((long long)r * nblk + b) * F + c;
      ag += part_g[o];
      ab += part_b[o];
    }
  }
  sg[warp][lane] = ag;
  sb[warp][lane] = ab;
  __syncthreads();
  if (warp == 0 && c < F) {
    float tg = 0.f, tb = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      tg += sg[w][lane];
      tb += sb[w][lane];
    }
    dgamma[(long long)r * F + c] = tg;
    dbeta[(long long)r * F + c] = tb;
  }
}

bool aligned4(const void* p, long long stride_a, long long stride_b, int F, size_t item) {
  return F % 4 == 0 && stride_a % 4 == 0 && stride_b % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % (4 * item) == 0;
}

template <typename Ti, typename To>
int launch_fwd(const void* x, const void* gamma, const void* beta, void* y, long long rows,
               int R, int F, long long xs_row, long long xs_run, cudaStream_t s) {
  const bool vx = aligned4(x, xs_row, xs_run, F, sizeof(Ti));
  const bool vy = aligned4(y, F, 0, F, sizeof(To));
  const long long blocks = (rows * R + WARPS - 1) / WARPS;
  ln_fwd_kernel<Ti, To><<<(unsigned)blocks, THREADS, 0, s>>>(
      (const Ti*)x, (const float*)gamma, (const float*)beta, (To*)y, rows, R, F, xs_row,
      xs_run, vx, vy);
  return (int)cudaGetLastError();
}

template <typename Tx, typename Tg>
int launch_bwd(const void* gy, const void* x, const void* gamma, void* dx, void* part_g,
               void* part_b, void* dgamma, void* dbeta, long long rows, int R, int F,
               long long xs_row, long long xs_run, int nblk, cudaStream_t s) {
  // dx is written in y's layout, whose rows are F apart like g's
  const bool vx = aligned4(x, xs_row, xs_run, F, sizeof(Tx)) &&
                  (dx == nullptr || aligned4(dx, F, 0, F, sizeof(Tx)));
  const bool vg = aligned4(gy, F, 0, F, sizeof(Tg));
  ln_bwd_kernel<Tx, Tg><<<dim3((unsigned)nblk, R), THREADS, 0, s>>>(
      (const Tg*)gy, (const Tx*)x, (const float*)gamma, (Tx*)dx, (float*)part_g,
      (float*)part_b, rows, R, F, xs_row, xs_run, vx, vg);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  ln_bwd_reduce_kernel<<<dim3((unsigned)((F + 31) / 32), R), THREADS, 0, s>>>(
      (const float*)part_g, (const float*)part_b, (float*)dgamma, (float*)dbeta, nblk, F);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. x: rows of F elements, row i of
// run r at x + i * xs_row + r * xs_run (elements); gamma, beta [R, F] f32;
// y [rows, R, F] in dtype_y. Returns cudaGetLastError().
int allset_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                          long long rows, int R, int F, long long xs_row, long long xs_run,
                          int dtype_x, int dtype_y, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (rows <= 0 || R <= 0 || F <= 0) return (int)cudaGetLastError();
  typedef __nv_bfloat16 bf;
  if (dtype_x == 0 && dtype_y == 0)
    return launch_fwd<float, float>(x, gamma, beta, y, rows, R, F, xs_row, xs_run, s);
  if (dtype_x == 0)
    return launch_fwd<float, bf>(x, gamma, beta, y, rows, R, F, xs_row, xs_run, s);
  if (dtype_y == 0)
    return launch_fwd<bf, float>(x, gamma, beta, y, rows, R, F, xs_row, xs_run, s);
  return launch_fwd<bf, bf>(x, gamma, beta, y, rows, R, F, xs_row, xs_run, s);
}

// gy [rows, R, F] in dtype_g; x as in the forward, in dtype_x; dx (null:
// not written) [rows, R, F] in dtype_x; part_g, part_b [R, nblk, F] f32
// scratch with nblk = ceil(rows / 64); dgamma, dbeta [R, F] f32.
int allset_layer_norm_bwd(const void* gy, const void* x, const void* gamma, void* dx,
                          void* part_g, void* part_b, void* dgamma, void* dbeta,
                          long long rows, int R, int F, long long xs_row, long long xs_run,
                          int nblk, int dtype_x, int dtype_g, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (rows <= 0 || R <= 0 || F <= 0) return (int)cudaGetLastError();
  if (nblk != (rows + BWD_ROWS - 1) / BWD_ROWS || R > 65535)
    return (int)cudaErrorInvalidValue;
  typedef __nv_bfloat16 bf;
  if (dtype_x == 0 && dtype_g == 0)
    return launch_bwd<float, float>(gy, x, gamma, dx, part_g, part_b, dgamma, dbeta, rows,
                                    R, F, xs_row, xs_run, nblk, s);
  if (dtype_x == 0)
    return launch_bwd<float, bf>(gy, x, gamma, dx, part_g, part_b, dgamma, dbeta, rows, R,
                                 F, xs_row, xs_run, nblk, s);
  if (dtype_g == 0)
    return launch_bwd<bf, float>(gy, x, gamma, dx, part_g, part_b, dgamma, dbeta, rows, R,
                                 F, xs_row, xs_run, nblk, s);
  return launch_bwd<bf, bf>(gy, x, gamma, dx, part_g, part_b, dgamma, dbeta, rows, R, F,
                            xs_row, xs_run, nblk, s);
}

}  // extern "C"
