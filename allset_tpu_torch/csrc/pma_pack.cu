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
// (about 350 MB per bench step); K4 reads only the score columns (one
// 32-byte sector per row). The design:
//   * K4: every thread keeps ONE head. Its elements of the flattened
//     [rows, H] score table are strided by a multiple of H, so it holds one
//     running max in a register; the block folds them with shared-memory
//     atomics and then one global atomicMax per head. Max is exact, so any
//     order gives the same bits. Values are clamped at 0 (gmax's initial
//     value, set by the caller), so their int bits order as the floats do;
//     NaN maps to 0x7fffffff, above every other value, so a NaN score
//     reaches gmax as NaN, as torch.amax propagates it.
//   * K5: one block per 32-row tile. The tile's e [rows, H] is computed
//     once into shared memory; then each thread reads a 16-byte vector of
//     yf and writes the 16-byte vector of w at the same columns. expf (not
//     __expf) keeps f32 within about 1 ulp of the plain version.
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
constexpr int TILE = 32;           // K5 rows per block
constexpr int GMAX_MAX_BLOCKS = 512;  // K4 blocks per run (threads loop)
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

template <typename T>
__global__ void gmax_kernel(const T* __restrict__ yf, const float* __restrict__ ba,
                            float* __restrict__ gmax, int rows, int R, int WP, int HC,
                            int H) {
  __shared__ int smax[MAX_H];
  const int run = blockIdx.y;
  for (int h = threadIdx.x; h < H; h += blockDim.x) smax[h] = 0;  // bits of +0.0
  __syncthreads();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // the largest multiple of H threads: each of them keeps head tid % H
  const long long stride = ((long long)gridDim.x * blockDim.x / H) * H;
  if (tid < stride) {
    const int h = (int)(tid % H);
    const float bah = ba[(size_t)run * H + h];
    const size_t ld = (size_t)R * WP;
    const T* col = yf + (size_t)run * WP + HC + h;
    int m = 0;
    for (long long row = tid / H; row < rows; row += stride / H) {
      const float a = leaky(to_f(col[(size_t)row * ld]) + bah);
      const int bits = isnan(a) ? 0x7fffffff : __float_as_int(a > 0.f ? a : 0.f);
      m = max(m, bits);
    }
    atomicMax(&smax[h], m);
  }
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += blockDim.x)
    atomicMax(reinterpret_cast<int*>(gmax) + (size_t)run * H + h, smax[h]);
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

template <typename T>
int launch_gmax(const void* yf, const void* ba, void* gmax, int rows, int R, int WP,
                int HC, int H, cudaStream_t s) {
  const long long n = (long long)rows * H;
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > GMAX_MAX_BLOCKS) blocks = GMAX_MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  gmax_kernel<T><<<dim3((unsigned)blocks, R), THREADS, 0, s>>>(
      (const T*)yf, (const float*)ba, (float*)gmax, rows, R, WP, HC, H);
  return (int)cudaGetLastError();
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

// dtype: 0 = float32, 1 = bfloat16 (yf, w). ba, bV and gmax are float32;
// gmax [R, H] must hold zeros on entry. Returns cudaGetLastError().
int allset_pma_gmax(const void* yf, const void* ba, void* gmax, int rows, int R, int WP,
                    int HC, int H, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (rows <= 0 || R <= 0 || H <= 0 || H > MAX_H) return (int)cudaGetLastError();
  if (dtype == 0) return launch_gmax<float>(yf, ba, gmax, rows, R, WP, HC, H, s);
  return launch_gmax<__nv_bfloat16>(yf, ba, gmax, rows, R, WP, HC, H, s);
}

int allset_pma_pack(const void* yf, const void* bV, const void* ba, const void* gmax,
                    void* w, int rows, int R, int WP, int HC, int H, int dtype,
                    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (rows <= 0 || R <= 0 || H <= 0 || H > MAX_H) return (int)cudaGetLastError();
  if (dtype == 0) return launch_pack<float>(yf, bV, ba, gmax, w, rows, R, WP, HC, H, s);
  return launch_pack<__nv_bfloat16>(yf, bV, ba, gmax, w, rows, R, WP, HC, H, s);
}

}  // extern "C"
