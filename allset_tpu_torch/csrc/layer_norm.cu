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
// (6 B per element), and F f32 partials per block of rows.
//
// B12: one warp per row (any F), lane l owning the 4-element chunks at
// 4l + 128k, loaded as one vector where the row is aligned, element by
// element otherwise (the same order of additions either way); the row's
// sums are per-lane sums folded by a fixed xor butterfly; the pass that
// writes y reads the row again (from L1/L2).
//
// B13 reads each row of x and g from memory once. Up to F = 1024 (the
// register path) a warp holds its row in registers: lane l owns the chunks
// of V elements at V(l + 32k), V = 8 where F % 8 == 0, 4 where F % 4 == 0,
// else 1 (chosen by F alone), loaded as 16- or 8-byte vectors where the row
// is aligned and element by element otherwise, in the same order of
// additions. From those registers the warp computes mu and rstd, mean(gg)
// and mean(gg * xh) (per-lane sums in chunk order, a fixed xor butterfly)
// and dx, and it adds g * xh and g of its columns into per-lane f32 sums,
// over its rows in row order. Where a row's raw bits take at most 16
// registers a lane, the next row is loaded before the current one is used.
// Each block owns a contiguous range of rows, rows_per_block(rows, F) of
// them, chosen from rows and F alone (about 1,056 blocks: 8 of 8 warps per
// SM); warp w takes rows w, w + 8, ... of it. The warps add their column
// sums in shared memory in warp order, and the block writes one [F]
// partial pair. Wider rows take ln_bwd_wide_kernel: one warp a block,
// each row read three times (the later passes from L2), the partial pair
// added to in global memory in row order. A second kernel sums a column's
// partials in a fixed order of blocks. No atomics: the bits repeat run to
// run.
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
constexpr float EPS = 1e-5f;
// B13's plan; ops/cuda_ln.py::bwd_plan computes the same
constexpr int REG_F = 1024;             // the widest row of the register path: 32 a lane
constexpr long long REG_BLOCKS = 1056;  // its blocks (8 warps each): 8 per SM of 132
constexpr long long REG_MIN_ROWS = 8;   // a row per warp at least
constexpr long long WIDE_BLOCKS = 4224; // the wide path's blocks (one warp each): 32 per SM
constexpr long long WIDE_MIN_ROWS = 16;
// the partials' sum: a block of 128 slots of RED_COLS columns; slot s sums
// the blocks s, s + 128, ...; then groups of RED_GROUP slots, then the groups
constexpr int RED_THREADS = 1024;
constexpr int RED_COLS = 8;
constexpr int RED_SLOTS = RED_THREADS / RED_COLS;
constexpr int RED_GROUP = 8;

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

// --- B13 ---------------------------------------------------------------------

// elements a lane takes at a time, by F alone (so a run folded with others
// is laid out as a launch on it alone)
int chunk_of(int F) { return F % 8 == 0 ? 8 : F % 4 == 0 ? 4 : 1; }

long long rows_per_block(long long rows, int F) {
  const bool reg = F <= REG_F;
  const long long blocks = reg ? REG_BLOCKS : WIDE_BLOCKS;
  const long long least = reg ? REG_MIN_ROWS : WIDE_MIN_ROWS;
  const long long r = (rows + blocks - 1) / blocks;
  return r < least ? least : r;
}

// V elements of T held as 32-bit words (bf16: two a word, the lower
// element in the low half)
template <typename T, int V>
struct Raw {
  static constexpr int W = (V * (int)sizeof(T) + 3) / 4;
  uint32_t w[W];
  __device__ __forceinline__ float at(int j) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[j]);
    } else {
      return __uint_as_float(j & 1 ? w[j >> 1] & 0xffff0000u : w[j >> 1] << 16);
    }
  }
};

// the V elements at p: vector loads where vec (p aligned to the chunk's
// bytes), else element by element; streaming (read once)
template <typename T, int V>
__device__ __forceinline__ void load_raw(Raw<T, V>& r, const T* p, bool vec) {
  constexpr int B = V * (int)sizeof(T);
  if constexpr (B >= 16) {
    if (vec) {
#pragma unroll
      for (int h = 0; h < B / 16; ++h) {
        const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p) + h);
        r.w[4 * h] = q.x;
        r.w[4 * h + 1] = q.y;
        r.w[4 * h + 2] = q.z;
        r.w[4 * h + 3] = q.w;
      }
      return;
    }
  } else if constexpr (B == 8) {
    if (vec) {
      const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
      r.w[0] = q.x;
      r.w[1] = q.y;
      return;
    }
  }
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < V; ++j) r.w[j] = __ldcs(reinterpret_cast<const unsigned int*>(p) + j);
  } else {
#pragma unroll
    for (int k = 0; k < Raw<T, V>::W; ++k) r.w[k] = 0u;
#pragma unroll
    for (int j = 0; j < V; ++j)
      r.w[j >> 1] |= (uint32_t)__ldcs(reinterpret_cast<const unsigned short*>(p) + j)
                     << (16 * (j & 1));
  }
}

// v rounded to T and stored at p, as vectors where vec; streaming (dx is
// not read back here)
template <typename T, int V>
__device__ __forceinline__ void store_chunk(T* p, const float (&v)[V], bool vec) {
  Raw<T, V> r;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < V; ++j) r.w[j] = __float_as_uint(v[j]);
  } else {
#pragma unroll
    for (int k = 0; k < Raw<T, V>::W; ++k) r.w[k] = 0u;
#pragma unroll
    for (int j = 0; j < V; ++j)
      r.w[j >> 1] |= (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[j])) << (16 * (j & 1));
  }
  constexpr int B = V * (int)sizeof(T);
  if constexpr (B >= 16) {
    if (vec) {
#pragma unroll
      for (int h = 0; h < B / 16; ++h)
        __stcs(reinterpret_cast<uint4*>(p) + h,
               make_uint4(r.w[4 * h], r.w[4 * h + 1], r.w[4 * h + 2], r.w[4 * h + 3]));
      return;
    }
  } else if constexpr (B == 8) {
    if (vec) {
      __stcs(reinterpret_cast<uint2*>(p), make_uint2(r.w[0], r.w[1]));
      return;
    }
  }
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < V; ++j) __stcs(reinterpret_cast<unsigned int*>(p) + j, r.w[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      __stcs(reinterpret_cast<unsigned short*>(p) + j,
             (unsigned short)(r.w[j >> 1] >> (16 * (j & 1))));
  }
}

// gamma's V elements at s (shared memory, aligned to the chunk)
template <int V>
__device__ __forceinline__ void gamma_chunk(const float* s, float (&gm)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      const float4 q = reinterpret_cast<const float4*>(s)[h];
      gm[4 * h] = q.x;
      gm[4 * h + 1] = q.y;
      gm[4 * h + 2] = q.z;
      gm[4 * h + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) gm[j] = s[j];
  }
}

// a row's K chunks of x and g into registers (chunks past F as zeros)
template <typename Tx, typename Tg, int V, int K>
__device__ __forceinline__ void load_row(Raw<Tx, V> (&xo)[K], Raw<Tg, V> (&go)[K], const Tx* xr,
                                         const Tg* gr, int F, int lane, bool vec_x, bool vec_g) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (k * 32 + lane) * V;
    if (c < F) {
      load_raw(xo[k], xr + c, vec_x);
      load_raw(go[k], gr + c, vec_g);
    } else {
#pragma unroll
      for (int w = 0; w < Raw<Tx, V>::W; ++w) xo[k].w[w] = 0u;
#pragma unroll
      for (int w = 0; w < Raw<Tg, V>::W; ++w) go[k].w[w] = 0u;
    }
  }
}

// The register path. Block (b, r): rows [b * rpb, (b + 1) * rpb) of run r,
// warp w its rows w, w + 8, ...; lane l the chunks c = V(l + 32k), k < K.
// Shared memory: gamma's row [F], then the warps' sums [2][WARPS][F].
template <typename Tx, typename Tg, int V, int K>
__global__ void __launch_bounds__(THREADS)
ln_bwd_reg_kernel(const Tg* __restrict__ gy, const Tx* __restrict__ x,
                  const float* __restrict__ gamma, Tx* __restrict__ dx,
                  float* __restrict__ part_g, float* __restrict__ part_b, long long rows, int R,
                  int F, long long xs_row, long long xs_run, long long rpb, bool vec_x,
                  bool vec_g, bool vec_dx) {
  // the next row is loaded ahead where the two rows' bits fit 32 registers
  constexpr bool kAhead = K * (Raw<Tx, V>::W + Raw<Tg, V>::W) <= 16;
  extern __shared__ float4 smem4[];
  float* s_gam = reinterpret_cast<float*>(smem4);
  float* s_g = s_gam + F;
  float* s_b = s_g + WARPS * F;
  const int r = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i0 = (long long)blockIdx.x * rpb;
  const long long i1 = i0 + rpb < rows ? i0 + rpb : rows;
  for (int c = threadIdx.x; c < F; c += THREADS) s_gam[c] = gamma[(long long)r * F + c];
  __syncthreads();

  float ag[K][V], ab[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) ag[k][j] = ab[k][j] = 0.f;
  Raw<Tx, V> xr[K];
  Raw<Tg, V> gr[K];
  long long i = i0 + warp;
  if (i < i1) load_row(xr, gr, x + i * xs_row + r * xs_run, gy + (i * R + r) * F, F, lane, vec_x,
                       vec_g);
  for (; i < i1; i += WARPS) {
    const long long nxt = i + WARPS;
    Raw<Tx, V> nx[K];
    Raw<Tg, V> ng[K];
    if constexpr (kAhead) {
      if (nxt < i1) load_row(nx, ng, x + nxt * xs_row + r * xs_run, gy + (nxt * R + r) * F, F,
                             lane, vec_x, vec_g);
    }
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if ((k * 32 + lane) * V < F) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float v = xr[k].at(j);
          s += v;
          s2 += v * v;
        }
      }
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / (float)F;
    const float rstd = rsqrtf(fmaxf(s2 / (float)F - mu * mu, 0.f) + EPS);
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = (k * 32 + lane) * V;
      if (c < F) {
        float gm[V];
        gamma_chunk<V>(s_gam + c, gm);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float gv = gr[k].at(j);
          const float xh = (xr[k].at(j) - mu) * rstd;
          const float gg = gv * gm[j];
          a1 += gg;
          a2 += gg * xh;
          ag[k][j] += gv * xh;
          ab[k][j] += gv;
        }
      }
    }
    const float m1 = warp_sum(a1) / (float)F;
    const float m2 = warp_sum(a2) / (float)F;
    if (dx != nullptr) {
      Tx* dr = dx + (i * R + r) * F;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = (k * 32 + lane) * V;
        if (c < F) {
          float gm[V], o[V];
          gamma_chunk<V>(s_gam + c, gm);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float xh = (xr[k].at(j) - mu) * rstd;
            o[j] = rstd * (gr[k].at(j) * gm[j] - m1 - xh * m2);
          }
          store_chunk<Tx, V>(dr + c, o, vec_dx);
        }
      }
    }
    if constexpr (kAhead) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        xr[k] = nx[k];
        gr[k] = ng[k];
      }
    } else if (nxt < i1) {
      load_row(xr, gr, x + nxt * xs_row + r * xs_run, gy + (nxt * R + r) * F, F, lane, vec_x,
               vec_g);
    }
  }
  // the block's partial pair: the warps' sums added in warp order
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (k * 32 + lane) * V;
    if (c < F) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s_g[warp * F + c + j] = ag[k][j];
        s_b[warp * F + c + j] = ab[k][j];
      }
    }
  }
  __syncthreads();
  const long long out = ((long long)r * gridDim.x + blockIdx.x) * F;
  for (int c = threadIdx.x; c < F; c += THREADS) {
    float tg = 0.f, tb = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      tg += s_g[w * F + c];
      tb += s_b[w * F + c];
    }
    part_g[out + c] = tg;
    part_b[out + c] = tb;
  }
}

// The wide path (F > REG_F): block (b, r) is one warp on rows [b * rpb,
// (b + 1) * rpb) of run r, with the register path's lane layout; each row
// is read for its statistics, again for mean(gg) and mean(gg * xh), and
// again for dx, and its g * xh and g are added to the block's partials in
// global memory (each lane to its own columns) in row order.
template <typename Tx, typename Tg, int V>
__global__ void __launch_bounds__(32)
ln_bwd_wide_kernel(const Tg* __restrict__ gy, const Tx* __restrict__ x,
                   const float* __restrict__ gamma, Tx* __restrict__ dx,
                   float* __restrict__ part_g, float* __restrict__ part_b, long long rows, int R,
                   int F, long long xs_row, long long xs_run, long long rpb, bool vec_x,
                   bool vec_g, bool vec_dx) {
  const int r = blockIdx.y, lane = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * rpb;
  const long long i1 = i0 + rpb < rows ? i0 + rpb : rows;
  const float* gam = gamma + (long long)r * F;
  const long long out = ((long long)r * gridDim.x + blockIdx.x) * F;
  float* pg = part_g + out;
  float* pb = part_b + out;
  for (int c = lane * V; c < F; c += 32 * V)
#pragma unroll
    for (int j = 0; j < V; ++j) pg[c + j] = pb[c + j] = 0.f;
  for (long long i = i0; i < i1; ++i) {
    const Tx* xr = x + i * xs_row + r * xs_run;
    const Tg* gr = gy + (i * R + r) * F;
    float s = 0.f, s2 = 0.f;
    for (int c = lane * V; c < F; c += 32 * V) {
      Raw<Tx, V> xv;
      load_raw(xv, xr + c, vec_x);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s += xv.at(j);
        s2 += xv.at(j) * xv.at(j);
      }
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / (float)F;
    const float rstd = rsqrtf(fmaxf(s2 / (float)F - mu * mu, 0.f) + EPS);
    float a1 = 0.f, a2 = 0.f;
    for (int c = lane * V; c < F; c += 32 * V) {
      Raw<Tx, V> xv;
      Raw<Tg, V> gv;
      load_raw(xv, xr + c, vec_x);
      load_raw(gv, gr + c, vec_g);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float gg = gv.at(j) * gam[c + j];
        a1 += gg;
        a2 += gg * ((xv.at(j) - mu) * rstd);
      }
    }
    const float m1 = warp_sum(a1) / (float)F;
    const float m2 = warp_sum(a2) / (float)F;
    Tx* dr = dx == nullptr ? nullptr : dx + (i * R + r) * F;
    for (int c = lane * V; c < F; c += 32 * V) {
      Raw<Tx, V> xv;
      Raw<Tg, V> gv;
      load_raw(xv, xr + c, vec_x);
      load_raw(gv, gr + c, vec_g);
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (xv.at(j) - mu) * rstd;
        o[j] = rstd * (gv.at(j) * gam[c + j] - m1 - xh * m2);
        pg[c + j] += gv.at(j) * xh;
        pb[c + j] += gv.at(j);
      }
      if (dr != nullptr) store_chunk<Tx, V>(dr + c, o, vec_dx);
    }
  }
}

// dgamma[r, c], dbeta[r, c] from the partials [R, nblk, F]: block (tile of
// RED_COLS columns, run r); slot s sums blocks s, s + RED_SLOTS, ... in
// order, then each group of RED_GROUP slots is summed in slot order, then
// the groups in group order.
__global__ void __launch_bounds__(RED_THREADS)
ln_bwd_reduce_kernel(const float* __restrict__ part_g, const float* __restrict__ part_b,
                     float* __restrict__ dgamma, float* __restrict__ dbeta, int nblk, int F) {
  constexpr int GROUPS = RED_SLOTS / RED_GROUP;
  __shared__ float sg[RED_SLOTS][RED_COLS];
  __shared__ float sb[RED_SLOTS][RED_COLS];
  __shared__ float tg_[GROUPS][RED_COLS];
  __shared__ float tb_[GROUPS][RED_COLS];
  const int r = blockIdx.y;
  const int col = threadIdx.x % RED_COLS, slot = threadIdx.x / RED_COLS;
  const int c = blockIdx.x * RED_COLS + col;
  float ag = 0.f, ab = 0.f;
  if (c < F) {
    const long long base = (long long)r * nblk * F + c;
#pragma unroll 4
    for (int b = slot; b < nblk; b += RED_SLOTS) {
      ag += part_g[base + (long long)b * F];
      ab += part_b[base + (long long)b * F];
    }
  }
  sg[slot][col] = ag;
  sb[slot][col] = ab;
  __syncthreads();
  if (threadIdx.x < GROUPS * RED_COLS) {
    const int grp = threadIdx.x / RED_COLS;
    float tg = 0.f, tb = 0.f;
#pragma unroll
    for (int s = grp * RED_GROUP; s < (grp + 1) * RED_GROUP; ++s) {
      tg += sg[s][col];
      tb += sb[s][col];
    }
    tg_[grp][col] = tg;
    tb_[grp][col] = tb;
  }
  __syncthreads();
  if (threadIdx.x < RED_COLS && c < F) {
    float tg = 0.f, tb = 0.f;
#pragma unroll
    for (int grp = 0; grp < GROUPS; ++grp) {
      tg += tg_[grp][col];
      tb += tb_[grp][col];
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

// rows of p at strides a and b (elements) start on V-element vector boundaries
bool aligned_v(const void* p, long long stride_a, long long stride_b, int V, size_t item) {
  return stride_a % V == 0 && stride_b % V == 0 &&
         reinterpret_cast<uintptr_t>(p) % (V * item) == 0;
}

struct BwdArgs {
  const void *gy, *x, *gamma;
  void *dx, *part_g, *part_b;
  long long rows;
  int R, F;
  long long xs_row, xs_run, rpb;
  int nblk;
  bool vx, vg, vdx;
};

template <typename Tx, typename Tg, int V, int K>
int launch_reg(const BwdArgs& a, cudaStream_t s) {
  const size_t smem = (size_t)(1 + 2 * WARPS) * a.F * sizeof(float);
  auto kern = ln_bwd_reg_kernel<Tx, Tg, V, K>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3((unsigned)a.nblk, a.R), THREADS, smem, s>>>(
      (const Tg*)a.gy, (const Tx*)a.x, (const float*)a.gamma, (Tx*)a.dx, (float*)a.part_g,
      (float*)a.part_b, a.rows, a.R, a.F, a.xs_row, a.xs_run, a.rpb, a.vx, a.vg, a.vdx);
  return (int)cudaGetLastError();
}

template <typename Tx, typename Tg, int V>
int launch_wide(const BwdArgs& a, cudaStream_t s) {
  ln_bwd_wide_kernel<Tx, Tg, V><<<dim3((unsigned)a.nblk, a.R), 32, 0, s>>>(
      (const Tg*)a.gy, (const Tx*)a.x, (const float*)a.gamma, (Tx*)a.dx, (float*)a.part_g,
      (float*)a.part_b, a.rows, a.R, a.F, a.xs_row, a.xs_run, a.rpb, a.vx, a.vg, a.vdx);
  return (int)cudaGetLastError();
}

// the row kernel by chunk width V and chunks per lane (K: the fewest of
// the instantiated counts that cover F)
template <typename Tx, typename Tg>
int launch_rows(const BwdArgs& a, cudaStream_t s) {
  const int V = chunk_of(a.F);
  if (a.F > REG_F) {
    if (V == 8) return launch_wide<Tx, Tg, 8>(a, s);
    if (V == 4) return launch_wide<Tx, Tg, 4>(a, s);
    return launch_wide<Tx, Tg, 1>(a, s);
  }
  const int k = (a.F / V + 31) / 32;
  if (V == 8) {
    if (k <= 1) return launch_reg<Tx, Tg, 8, 1>(a, s);
    if (k <= 2) return launch_reg<Tx, Tg, 8, 2>(a, s);
    return launch_reg<Tx, Tg, 8, 4>(a, s);
  }
  if (V == 4) {
    if (k <= 1) return launch_reg<Tx, Tg, 4, 1>(a, s);
    if (k <= 2) return launch_reg<Tx, Tg, 4, 2>(a, s);
    if (k <= 4) return launch_reg<Tx, Tg, 4, 4>(a, s);
    return launch_reg<Tx, Tg, 4, 8>(a, s);
  }
  if (k <= 8) return launch_reg<Tx, Tg, 1, 8>(a, s);
  if (k <= 16) return launch_reg<Tx, Tg, 1, 16>(a, s);
  return launch_reg<Tx, Tg, 1, 32>(a, s);
}

template <typename Tx, typename Tg>
int launch_bwd(BwdArgs a, void* dgamma, void* dbeta, cudaStream_t s) {
  const int V = chunk_of(a.F);
  a.rpb = rows_per_block(a.rows, a.F);
  a.vx = aligned_v(a.x, a.xs_row, a.xs_run, V, sizeof(Tx));
  a.vg = aligned_v(a.gy, a.F, 0, V, sizeof(Tg));  // g and dx: rows F apart (y's layout)
  a.vdx = a.dx == nullptr || aligned_v(a.dx, a.F, 0, V, sizeof(Tx));
  const int rc = launch_rows<Tx, Tg>(a, s);
  if (rc != 0) return rc;
  ln_bwd_reduce_kernel<<<dim3((unsigned)((a.F + RED_COLS - 1) / RED_COLS), a.R), RED_THREADS, 0,
                         s>>>((const float*)a.part_g, (const float*)a.part_b, (float*)dgamma,
                              (float*)dbeta, a.nblk, a.F);
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
// scratch with nblk = ceil(rows / rows_per_block(rows, F)) (about 1,056
// blocks up to F = 1024, 4,224 above; ops/cuda_ln.py::bwd_plan); dgamma,
// dbeta [R, F] f32.
int allset_layer_norm_bwd(const void* gy, const void* x, const void* gamma, void* dx,
                          void* part_g, void* part_b, void* dgamma, void* dbeta,
                          long long rows, int R, int F, long long xs_row, long long xs_run,
                          int nblk, int dtype_x, int dtype_g, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (rows <= 0 || R <= 0 || F <= 0) return (int)cudaGetLastError();
  const long long rpb = rows_per_block(rows, F);
  if (nblk != (rows + rpb - 1) / rpb || R > 65535) return (int)cudaErrorInvalidValue;
  const BwdArgs a{gy, x, gamma, dx, part_g, part_b, rows, R, F, xs_row, xs_run, rpb, nblk,
                  false, false, false};
  typedef __nv_bfloat16 bf;
  if (dtype_x == 0 && dtype_g == 0) return launch_bwd<float, float>(a, dgamma, dbeta, s);
  if (dtype_x == 0) return launch_bwd<float, bf>(a, dgamma, dbeta, s);
  if (dtype_g == 0) return launch_bwd<bf, float>(a, dgamma, dbeta, s);
  return launch_bwd<bf, bf>(a, dgamma, dbeta, s);
}

}  // extern "C"
