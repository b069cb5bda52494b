// K4 / K5: PMA's score+pack, the packed exchange table of one PMA forward.
//
// Replaces allset_tpu/ops/pallas_pack.py::_gmax_kernel (K4) and ::_pack_kernel
// (K5). Input: the [lin_V | Wa] GEMM output yf = [x_V HC | scores H | 0],
// padded with zero GEMM columns to WP (a multiple of 8), in the activation
// dtype T:
//   K4: gmax[h] = max(0, max over all rows of leaky(f32(yf[:, HC+h]) + ba[h])),
//       f32, leaky = leaky_relu with slope 0.2;
//   K5, per row: x_V = round(yf[:, :HC] + round(bV));
//       e = round(exp(leaky(f32(yf[:, HC:HC+H]) + ba) - gmax));
//       w = [round(x_V * e expanded over C = HC / H) | e | 0] in T.
// round() rounds to T; the rounding points are those of the plain version
// (allset_tpu_torch/ops/cuda_pack.py::pack_plain).
//
// What bounds them on the H100: bytes. K5 reads yf once and writes w once
// (about 350 MB per bench step); K4 reads only the score columns (H
// values of each row and run). The design:
//   * K4 is one launch that writes gmax itself (no memset before it).
//     blockIdx.y is the run. Thread g of a run keeps head vector g % NHV
//     (VH heads: 16 bytes when the layout allows, else 8, 4 or 2), so its
//     VH running maxima stay in registers, and walks the rows g / NHV, g
//     / NHV + G / NHV, ... with 8 vector loads in flight. Lanes of a warp
//     that hold the same heads are folded with shuffles (NHV a power of
//     two up to 32), the block with shared-memory atomics, and each block
//     writes its [H] maxima to its row of a [R, blocks, H] scratch. The
//     last block of a run, found by atomicInc on the run's ticket (which
//     wraps back to 0 by itself, so the tickets stay zero between
//     launches), folds the run's rows and writes gmax. Max is exact, so
//     any order gives the same bits. Values are clamped at 0, so their int
//     bits order as the floats do; NaN maps to 0x7fffffff, above every
//     other value, so a NaN score reaches gmax as NaN, as torch.amax
//     propagates it. The grid fills the SMs over all (row, run) pairs,
//     at least 8 vectors a thread (ops/cuda_pack.py::gmax_grid). (Threads
//     that read the runs of one row side by side, the alternative, were
//     slower at the 20-run epoch's shapes.)
//   * K5: one block per 32-row tile. The tile's e [rows, H] is computed
//     once into shared memory; then each thread reads a 16-byte vector of
//     yf and writes the 16-byte vector of w at the same columns. expf (not
//     __expf) keeps f32 within about 1 ulp of the plain version.
//   * one C entry, allset_pma_score_pack, launches K4, K5 or K4 then K5
//     on one stream: the pack's forward is one host call.
// Runs (the statistical runs folded into the width): yf is [rows, R, WP] =
// [rows, R*WP], w has the same layout (the folded table dir_spmm takes), bV
// is [R, HC], ba and gmax [R, H]. blockIdx.y is the run: a block offsets its
// pointers to its run and steps rows by R*WP, so run r's output equals a
// single-run launch on its slice, bit for bit. R = 1 is the single-run
// layout.
// Shapes: WP % 8 == 0, WP >= HC + H, H divides HC, H <= 256, 16-byte
// aligned yf and w.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_H = 256;
constexpr int TILE = 32;          // K5 rows per block
constexpr int GMAX_INFLIGHT = 8;  // K4 vector loads in flight a thread
constexpr float SLOPE = 0.2f;

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

// torch's leaky_relu: a > 0 ? a : a * slope
__device__ __forceinline__ float leaky(float a) { return a > 0.f ? a : a * SLOPE; }

// clamped at 0, as int bits that order as the floats do; NaN above all
__device__ __forceinline__ int max_bits(float a) {
  return isnan(a) ? 0x7fffffff : __float_as_int(a > 0.f ? a : 0.f);
}

template <typename T, int VH>
struct alignas(VH * sizeof(T)) HeadVec {
  T v[VH];
};

// K4. Grid (blocks, R): blockIdx.y is the run; scratch [R, blocks, H]
// int, tickets [R] uint, zero on entry and on exit.
template <typename T, int VH>
__global__ void __launch_bounds__(THREADS)
gmax_kernel(const T* __restrict__ yf, const float* __restrict__ ba, float* __restrict__ gmax,
            int* __restrict__ scratch, unsigned* __restrict__ tickets, int rows, int R, int WP,
            int HC, int H) {
  __shared__ int smax[MAX_H];
  __shared__ bool last;
  const int run = blockIdx.y, nblk = gridDim.x;
  const int nhv = H / VH;
  for (int h = threadIdx.x; h < H; h += THREADS) smax[h] = 0;  // bits of +0.0
  __syncthreads();
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  // the largest multiple of nhv threads: each keeps head vector tid % nhv
  const long long stride = ((long long)nblk * THREADS / nhv) * nhv;
  const int hv = (int)(tid % nhv);
  int m[VH];
#pragma unroll
  for (int i = 0; i < VH; ++i) m[i] = 0;
  if (tid < stride) {
    float bah[VH];
#pragma unroll
    for (int i = 0; i < VH; ++i) bah[i] = ba[(size_t)run * H + hv * VH + i];
    const size_t ld = (size_t)R * WP;
    const T* col = yf + (size_t)run * WP + HC + hv * VH;
    const long long step = stride / nhv;
    for (long long row = tid / nhv; row < rows; row += GMAX_INFLIGHT * step) {
      HeadVec<T, VH> x[GMAX_INFLIGHT];
#pragma unroll
      for (int u = 0; u < GMAX_INFLIGHT; ++u)
        if (row + u * step < rows)
          x[u] = *reinterpret_cast<const HeadVec<T, VH>*>(col + (size_t)(row + u * step) * ld);
#pragma unroll
      for (int u = 0; u < GMAX_INFLIGHT; ++u)
        if (row + u * step < rows) {
#pragma unroll
          for (int i = 0; i < VH; ++i)
            m[i] = max(m[i], max_bits(leaky(to_f(x[u].v[i]) + bah[i])));
        }
    }
  }
  // lanes tid % nhv hold the same heads when nhv divides 32 (warps start
  // at multiples of 32): fold them with shuffles first, one atomic per
  // head and warp
  const int lane = threadIdx.x & 31;
  if (nhv <= 32 && (32 % nhv) == 0) {
    for (int off = 16; off >= nhv; off >>= 1)
#pragma unroll
      for (int i = 0; i < VH; ++i) m[i] = max(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));
    if (lane < nhv)
#pragma unroll
      for (int i = 0; i < VH; ++i) atomicMax(&smax[hv * VH + i], m[i]);
  } else if (tid < stride) {
#pragma unroll
    for (int i = 0; i < VH; ++i) atomicMax(&smax[hv * VH + i], m[i]);
  }
  __syncthreads();
  int* mine = scratch + ((size_t)run * nblk + blockIdx.x) * H;
  for (int h = threadIdx.x; h < H; h += THREADS) mine[h] = smax[h];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(&tickets[run], (unsigned)nblk - 1) == (unsigned)nblk - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the run's last block: fold every block's row (read past L1)
  const int* rs = scratch + (size_t)run * nblk * H;
  for (int i = threadIdx.x; i < nblk * H; i += THREADS) atomicMax(&smax[i % H], __ldcg(rs + i));
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += THREADS)
    gmax[(size_t)run * H + h] = __int_as_float(smax[h]);
}

template <typename T>
__global__ void pack_kernel(const T* __restrict__ yf, const float* __restrict__ bV,
                            const float* __restrict__ ba, const float* __restrict__ gmax,
                            T* __restrict__ w, int rows, int R, int WP, int HC, int H) {
  extern __shared__ float se[];  // [TILE, H]: the tile's e, rounded to T
  constexpr int V = 16 / sizeof(T);
  const int run = blockIdx.y;
  const int row0 = blockIdx.x * TILE;
  const int nrow = min(TILE, rows - row0);
  const size_t ld = (size_t)R * WP;
  const T* src = yf + (size_t)row0 * ld + (size_t)run * WP;
  T* dst = w + (size_t)row0 * ld + (size_t)run * WP;
  const float* bar = ba + (size_t)run * H;
  const float* gm = gmax + (size_t)run * H;
  const float* bv = bV + (size_t)run * HC;
  for (int i = threadIdx.x; i < nrow * H; i += blockDim.x) {
    const int row = i / H, h = i - row * H;
    const float a = leaky(to_f(src[(size_t)row * ld + HC + h]) + bar[h]);
    se[i] = round_to<T>(expf(a - gm[h]));
  }
  __syncthreads();
  const int nvec = WP / V;
  const int C = HC / H;
  for (int i = threadIdx.x; i < nrow * nvec; i += blockDim.x) {
    const int row = i / nvec, v = i - row * nvec;
    const size_t off = (size_t)row * ld + (size_t)v * V;
    const uint4 in = *reinterpret_cast<const uint4*>(src + off);
    const T* x = reinterpret_cast<const T*>(&in);
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
    const float* e = se + row * H;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = v * V + j;
      float val = 0.f;
      if (c < HC) {
        const float xv = round_to<T>(to_f(x[j]) + round_to<T>(bv[c]));
        val = xv * e[c / C];
      } else if (c < HC + H) {
        val = e[c - HC];
      }
      o[j] = from_f<T>(val);
    }
    *reinterpret_cast<uint4*>(dst + off) = out;
  }
}

template <typename T, int VH>
int launch_gmax_vh(const void* yf, const void* ba, void* gmax, void* scratch, void* tickets,
                   int blocks, int rows, int R, int WP, int HC, int H, cudaStream_t s) {
  gmax_kernel<T, VH><<<dim3((unsigned)blocks, R), THREADS, 0, s>>>(
      (const T*)yf, (const float*)ba, (float*)gmax, (int*)scratch, (unsigned*)tickets, rows, R,
      WP, HC, H);
  return (int)cudaGetLastError();
}

// vh heads a thread loads at once (ops/cuda_pack.py::head_vec chooses it:
// 16 bytes or fewer, dividing H, HC and WP)
template <typename T>
int launch_gmax(const void* yf, const void* ba, void* gmax, void* scratch, void* tickets,
                int blocks, int vh, int rows, int R, int WP, int HC, int H, cudaStream_t s) {
  if (vh <= 0 || vh * (int)sizeof(T) > 16 || H % vh || HC % vh || WP % vh)
    return (int)cudaErrorInvalidValue;
  switch (vh) {
    case 1:
      return launch_gmax_vh<T, 1>(yf, ba, gmax, scratch, tickets, blocks, rows, R, WP, HC, H, s);
    case 2:
      return launch_gmax_vh<T, 2>(yf, ba, gmax, scratch, tickets, blocks, rows, R, WP, HC, H, s);
    case 4:
      return launch_gmax_vh<T, 4>(yf, ba, gmax, scratch, tickets, blocks, rows, R, WP, HC, H, s);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_gmax_vh<T, 8>(yf, ba, gmax, scratch, tickets, blocks, rows, R, WP, HC, H,
                                    s);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_pack(const void* yf, const void* bV, const void* ba, const void* gmax,
                void* w, int rows, int R, int WP, int HC, int H, cudaStream_t s) {
  const size_t smem = (size_t)TILE * H * sizeof(float);
  pack_kernel<T><<<dim3((rows + TILE - 1) / TILE, R), THREADS, smem, s>>>(
      (const T*)yf, (const float*)bV, (const float*)ba, (const float*)gmax, (T*)w, rows,
      R, WP, HC, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The pack's forward, or one of its kernels: parts & 1 launches K4 into
// gmax [R, H], parts & 2 then launches K5 from gmax into w [rows, R*WP].
// dtype: 0 = float32, 1 = bfloat16 (yf, w); ba, bV and gmax are float32.
// K4 takes scratch [R, blocks, H] int32 and tickets [R] uint32, zero on
// entry (and left zero), blocks a run (ops/cuda_pack.py::gmax_grid) and vh
// heads a thread (head_vec). Returns cudaGetLastError() after the
// launches.
int allset_pma_score_pack(const void* yf, const void* bV, const void* ba, void* gmax, void* w,
                          void* scratch, void* tickets, int blocks, int vh, int rows, int R,
                          int WP, int HC, int H, int dtype, int parts, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (rows < 0 || R <= 0 || H <= 0 || H > MAX_H || parts < 1 || parts > 3)
    return (int)cudaErrorInvalidValue;
  if (parts & 1) {
    if (blocks <= 0) return (int)cudaErrorInvalidValue;
    const int e = dtype == 0 ? launch_gmax<float>(yf, ba, gmax, scratch, tickets, blocks, vh,
                                                  rows, R, WP, HC, H, s)
                             : launch_gmax<__nv_bfloat16>(yf, ba, gmax, scratch, tickets, blocks,
                                                          vh, rows, R, WP, HC, H, s);
    if (e != 0) return e;
  }
  if (!(parts & 2) || rows == 0) return (int)cudaGetLastError();
  if (dtype == 0) return launch_pack<float>(yf, bV, ba, gmax, w, rows, R, WP, HC, H, s);
  return launch_pack<__nv_bfloat16>(yf, bV, ba, gmax, w, rows, R, WP, HC, H, s);
}

}  // extern "C"
