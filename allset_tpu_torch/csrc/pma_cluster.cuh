// The cluster layout shared by K2 (pma_epilogue_cluster.cu) and K3a
// (pma_epilogue_cluster_bwd.cu) at HC 384 and 512: a cluster of two
// blocks per 64-row tile, block c owning the output columns [c HC/2, (c +
// 1) HC/2) as HC / 128 warpgroups of 64 columns; the A operand's halves
// written into both blocks' buffers (distributed shared memory), the row
// statistics as block 0's partial plus block 1's, and the products over
// each block's column half of the weight slabs from a ring of bulk copies
// (pma_epilogue_cluster.cu's note has the design).

#pragma once

#include <cooperative_groups.h>

#include "pma_wgmma.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int CL_TM = 64;  // rows per tile

// one slab of a block's N-half (HC / 2 columns): bf16 WG_KSB k-rows, f32
// WG_KSF k-rows of plain f32 (split in shared memory)
template <typename T>
__host__ __device__ constexpr uint32_t cl_slot(int HC) {
  return (uint32_t)wg_ksf<T>() * (HC / 2) * sizeof(T);
}

// A cluster barrier in two halves, so that work between them overlaps it:
// the arrival (releasing this thread's earlier writes, local and remote)
// and the wait (acquiring the peer's).
__device__ __forceinline__ void cl_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cl_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// cl_row_sum's halves: the block's partial into blk[ex], then the
// arrival; the wait, then the pair's totals in pa, pb.
template <int NWG>
__device__ __forceinline__ void cl_row_part(float (&pa)[2], float (&pb)[2], float* red, float* blk,
                                            int ex, const WgLane& ln) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pa[h] += __shfl_xor_sync(0xffffffffu, pa[h], 1);
    pa[h] += __shfl_xor_sync(0xffffffffu, pa[h], 2);
    pb[h] += __shfl_xor_sync(0xffffffffu, pb[h], 1);
    pb[h] += __shfl_xor_sync(0xffffffffu, pb[h], 2);
  }
  if (ln.t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      red[(ln.q * 2 + 0) * CL_TM + ln.row(2 * h)] = pa[h];
      red[(ln.q * 2 + 1) * CL_TM + ln.row(2 * h)] = pb[h];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * CL_TM) {  // (statistic, row) = (threadIdx.x / 64, threadIdx.x % 64)
    const int st = threadIdx.x / CL_TM, r = threadIdx.x % CL_TM;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < NWG; ++q) s += red[(q * 2 + st) * CL_TM + r];
    blk[ex * 2 * CL_TM + threadIdx.x] = s;
  }
  cl_arrive();
}
__device__ __forceinline__ void cl_row_total(float (&pa)[2], float (&pb)[2], const float* blk0,
                                             const float* blk1, int ex, const WgLane& ln) {
  cl_wait();
  const float* b0 = blk0 + ex * 2 * CL_TM;
  const float* b1 = blk1 + ex * 2 * CL_TM;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ln.row(2 * h);
    pa[h] = b0[r] + b1[r];
    pb[h] = b0[CL_TM + r] + b1[CL_TM + r];
  }
}

// Row totals of two per-element quantities over all HC columns of the
// pair: pa[h], pb[h] hold the thread's sums for its rows (h = 0: row(0),
// 1: row(2)); on return, the totals. The t lanes by a shuffle tree, the
// block's NWG warpgroups in order (red, then blk[ex], by the first 128
// threads), then block 0's partial plus block 1's (blk0, blk1: local or
// the peer's). One block barrier and one cluster barrier, which
// cl_row_part and cl_row_total split so that work needing neither can
// run between them.
template <int NWG>
__device__ __forceinline__ void cl_row_sum(float (&pa)[2], float (&pb)[2], float* red, float* blk,
                                           const float* blk0, const float* blk1, int ex,
                                           const WgLane& ln) {
  cl_row_part<NWG>(pa, pb, red, blk, ex, ln);
  cl_row_total(pa, pb, blk0, blk1, ex, ln);
}

// The offset of A operand element (r, col) in a block's A buffer: f32
// rows of LD (A is read into registers), bf16 wgmma's K-major core
// matrices (8 rows x 16 bytes, 128 contiguous bytes), the 8 row groups of
// a k chunk of 8 after one another (A is read through a descriptor)
template <typename T, int LD>
__device__ __forceinline__ int a_off(int r, int col) {
  if constexpr (sizeof(T) == 2)
    return (col >> 3) * 512 + (r >> 3) * 64 + (r & 7) * 8 + (col & 7);
  else
    return r * LD + col;
}

// The thread's share of the next product's A operand (its 16 columns of
// two rows) into this block's A buffer and the peer's.
template <typename T, int LD>
__device__ __forceinline__ void cl_put_a(const float (&x)[8][4], T* sA, T* pA, int n0,
                                         const WgLane& ln) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = a_off<T, LD>(ln.row(2 * h), n0 + 8 * j + 2 * ln.t);
      store2(sA + off, x[j][2 * h], x[j][2 * h + 1]);
      store2(pA + off, x[j][2 * h], x[j][2 * h + 1]);
    }
  // bf16: both blocks' products read A through the async proxy
  if constexpr (sizeof(T) == 2) asm volatile("fence.proxy.async;\n" ::: "memory");
}

// acc = A @ B in bf16 over one product's HC / KS slabs (KS k-rows each)
// from the ring, A [64][HC] in the core-matrix layout (a_off) and each
// slab through descriptors: per slab the warpgroup waits for the slab and
// issues its products, and once the previous slab's products are done
// (one group in flight) each warp counts itself done with that slab's
// slot; the last of the block's nwarps refills it with the slab nst
// further on (fill).
template <int HC, int KS = WG_KSB, typename Fill>
__device__ __forceinline__ void cl_product_bf16(float (&acc)[8][4], const char* sA,
                                                const char* ring, uint64_t* full, uint32_t* done,
                                                uint32_t nwarps, uint32_t& it, uint32_t nst,
                                                const WgLane& ln, Fill& fill) {
  constexpr int NS = HC / KS, KK = KS / 16;
  constexpr uint32_t LBO = (HC / 2) * 16, SLOT = KS * (HC / 2) * 2;
  const uint32_t n_off = ln.q * 8 * 128;  // the warpgroup's first n-group of core matrices
  const uint32_t a0 = smem_u32(sA);
  auto release = [&](uint32_t n) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0 &&
        atomicAdd(&done[n % nst], 1u) + 1 == (n / nst + 1) * nwarps)
      fill(n + nst);
    __syncwarp();
  };
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  fence_acc(acc);
  wg_fence();
#pragma unroll 1
  for (int s = 0; s < NS; ++s) {
    const uint32_t n = it + s, slot = n % nst;
    mbar_wait(&full[slot], (n / nst) & 1);
    const uint32_t b = smem_u32(ring + slot * SLOT) + n_off;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      wgmma_bf16_ss(acc, desc_k(a0 + (s * KK + kk) * 2048, 1024, 128),
                    desc_k(b + 2 * kk * LBO, LBO, 128));
    wg_commit();
    if (s > 0) {
      wg_wait<1>();
      release(n - 1);
    }
  }
  wg_wait<0>();
  release(it + NS - 1);
  fence_acc(acc);
  it += NS;
}

// acc = A @ B at f32 accuracy (3xTF32) over one product's HC / WG_KSF
// slabs of plain f32 from the ring: A [64][HC + 4] f32 in shared memory,
// slab n in slot n % nst. The block splits slab n + 1 (hi in place, lo
// into lo buffer (n + 1) % 2) while slab n's products run; one block
// barrier a slab, after which slot n % nst is free and thread 0 refills it
// with slab n + nst (fill). The first slab of the product is split before
// it (the previous product's last barrier freed its lo buffer). Where the
// ring also serves cl_product_bf16 (done), thread 0 counts the block's
// nwarps done with the slot, as that product's release expects.
template <int HC, typename Fill>
__device__ __forceinline__ void cl_product_f32(float (&acc)[8][4], const char* sA, char* ring,
                                               char* lobuf, uint64_t* full, uint32_t& it,
                                               uint32_t nst, const WgLane& ln, Fill& fill,
                                               uint32_t* done = nullptr, uint32_t nwarps = 0) {
  constexpr int NS = HC / WG_KSF, KK = WG_KSF / 8;
  constexpr uint32_t LBO = (HC / 2) * 16, SLOT = cl_slot<float>(HC);
  const uint32_t n_off = ln.q * 8 * 128;  // the warpgroup's first n-group of core matrices
  auto split = [&](uint32_t n) {
    const uint32_t slot = n % nst;
    mbar_wait(&full[slot], (n / nst) & 1);
    float4* hi = reinterpret_cast<float4*>(ring + slot * SLOT);
    float4* lo = reinterpret_cast<float4*>(lobuf + (n & 1) * SLOT);
    for (int i = threadIdx.x; i < (int)(SLOT / 16); i += HC) {
      const float4 v = hi[i];
      uint32_t h[4], l[4];
      split_tf32(v.x, h[0], l[0]);
      split_tf32(v.y, h[1], l[1]);
      split_tf32(v.z, h[2], l[2]);
      split_tf32(v.w, h[3], l[3]);
      hi[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                          __uint_as_float(h[3]));
      lo[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                          __uint_as_float(l[3]));
    }
    // these writes before the products (the async proxy) read them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  fence_acc(acc);
  split(it);
  __syncthreads();
#pragma unroll 1
  for (int s = 0; s < NS; ++s) {
    const uint32_t n = it + s;
    uint32_t ah[KK][4], al[KK][4];
    wg_a_frags<HC, false>(sA, s, ln, ah, al);
    wg_fence();
    const uint32_t bh = smem_u32(ring + (n % nst) * SLOT) + n_off;
    const uint32_t bl = smem_u32(lobuf + (n & 1) * SLOT) + n_off;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint64_t dh = desc_k(bh + 2 * kk * LBO, LBO, 128);
      const uint64_t dl = desc_k(bl + 2 * kk * LBO, LBO, 128);
      wgmma_tf32(acc, al[kk], dh);
      wgmma_tf32(acc, ah[kk], dl);
      wgmma_tf32(acc, ah[kk], dh);
    }
    wg_commit();
    if (s + 1 < NS) split(n + 1);
    wg_wait<0>();
    __syncthreads();  // slab n + 1 split; every warpgroup done with slab n
    if (threadIdx.x == 0) {
      if (done) done[n % nst] += nwarps;
      fill(n + nst);
    }
  }
  fence_acc(acc);
  it += NS;
}

}  // namespace
