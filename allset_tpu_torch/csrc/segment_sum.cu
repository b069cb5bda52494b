// K1: sorted CSR segment-sum, out[m] = sum_{indptr[m] <= i < indptr[m+1]} msgs[i].
//
// Replaces allset_tpu/ops/pallas_segment.py::_kernel (the TPU one-hot MXU
// reduce). On the H100 the op is bound by bytes: it reads every message
// row once and writes every segment row once, with no reuse. The design
// keeps both streams contiguous and does nothing else:
//   * one warp per (segment, column tile); a tile is 32 16-byte vectors
//     (256 bf16 or 128 f32 columns), one per lane, so a row's tile is
//     read by one coalesced warp access. The second grid axis runs over
//     the tiles: a wide row (runs folded into the width, W = R * 264)
//     spreads across warps instead of being walked tile after tile;
//   * each lane sums its vector over the segment's rows in f32, in row
//     order (four rows loaded ahead for memory-level parallelism, added
//     in order): no atomics, so the result is deterministic, and a
//     column's sum does not depend on W or on the tiling;
//   * the store is in the input dtype; an empty segment stores zeros.
// The row width W must be a multiple of 8 (any such width: 264, 384,
// R * 264...). Segments are not balanced: a hot segment is one warp's
// work per tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kTileVecs = 32;  // 16-byte vectors per column tile (one per lane)

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void add_vec(float* acc, uint4 v, float) {
  acc[0] += __uint_as_float(v.x);
  acc[1] += __uint_as_float(v.y);
  acc[2] += __uint_as_float(v.z);
  acc[3] += __uint_as_float(v.w);
}

__device__ __forceinline__ void add_vec(float* acc, uint4 v, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    acc[2 * i] += f.x;
    acc[2 * i + 1] += f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* acc) {
  *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* acc) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ msgs,
                                   const int* __restrict__ indptr,
                                   T* __restrict__ out, int num_seg, int W) {
  constexpr int V = Vec<T>::N;
  const int seg = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int c = blockIdx.y * kTileVecs + (threadIdx.x & 31);  // this lane's vector
  if (seg >= num_seg || c >= W / V) return;
  const int start = indptr[seg];
  const int end = indptr[seg + 1];
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  const T* p = msgs + (size_t)start * W + (size_t)c * V;
  int r = start;
  for (; r + 4 <= end; r += 4) {
    uint4 v0 = load16(p);
    uint4 v1 = load16(p + W);
    uint4 v2 = load16(p + 2 * (size_t)W);
    uint4 v3 = load16(p + 3 * (size_t)W);
    add_vec(acc, v0, T());
    add_vec(acc, v1, T());
    add_vec(acc, v2, T());
    add_vec(acc, v3, T());
    p += 4 * (size_t)W;
  }
  for (; r < end; ++r) {
    add_vec(acc, load16(p), T());
    p += W;
  }
  store_vec(out + (size_t)seg * W + (size_t)c * V, acc);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
int allset_segment_sum(const void* msgs, const void* indptr, void* out,
                       int num_seg, int W, int dtype, void* stream) {
  if (num_seg > 0 && W > 0) {
    const int nvec = W / (dtype == 0 ? Vec<float>::N : Vec<__nv_bfloat16>::N);
    dim3 grid((num_seg + kWarpsPerBlock - 1) / kWarpsPerBlock,
              (nvec + kTileVecs - 1) / kTileVecs);
    dim3 block(32 * kWarpsPerBlock);
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (dtype == 0) {
      segment_sum_kernel<float><<<grid, block, 0, s>>>(
          static_cast<const float*>(msgs), static_cast<const int*>(indptr),
          static_cast<float*>(out), num_seg, W);
    } else {
      segment_sum_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          static_cast<const __nv_bfloat16*>(msgs), static_cast<const int*>(indptr),
          static_cast<__nv_bfloat16*>(out), num_seg, W);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* allset_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
