// Hopper primitives shared by the warpgroup kernels of the PMA epilogue
// (pma_epilogue_wg.cu: K3a, K3b and K2 at HC 256; pma_epilogue_cluster.cu:
// K2 at HC 384 and 512): mbarriers, bulk copies (the TMA's linear mode),
// wgmma with A from registers and B through a shared-memory descriptor,
// and the lane's place in a warpgroup's accumulator.

#pragma once

#include "pma_epilogue.cuh"

namespace {

// --- Hopper primitives (inline PTX) -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
// wait for the completion of the barrier's phase of the given parity
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}
// bytes from global to shared memory by the TMA unit, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// an arrival on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of the accumulator across the
// asynchronous products
template <int NT>
__device__ __forceinline__ void fence_acc(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand without swizzle:
// 8-row x 16-byte core matrices, each 128 contiguous bytes; lbo the bytes
// between core matrices along k, sbo along the rows (n or m).
__device__ __forceinline__ uint64_t desc_k(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d[64, 8 NT] += A[64, k16 or k8] (registers: the mma.sync fragment of the
// warp's 16 rows) x B (descriptor), wgmma with A in registers; bf16 (k16)
// and tf32 (k8). Accumulator element (j, e) of a thread: row 16 w + g +
// 8 (e / 2), column 8 j + 2 t + e % 2 of the warpgroup's tile.
#define WG_D4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
__device__ __forceinline__ void wgmma_bf16(float (&d)[8][4], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3),
        WG_D4(4), WG_D4(5), WG_D4(6), WG_D4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3),
        WG_D4(4), WG_D4(5), WG_D4(6), WG_D4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[16][4], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3),
        WG_D4(4), WG_D4(5), WG_D4(6), WG_D4(7),
        WG_D4(8), WG_D4(9), WG_D4(10), WG_D4(11),
        WG_D4(12), WG_D4(13), WG_D4(14), WG_D4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16][4], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3),
        WG_D4(4), WG_D4(5), WG_D4(6), WG_D4(7),
        WG_D4(8), WG_D4(9), WG_D4(10), WG_D4(11),
        WG_D4(12), WG_D4(13), WG_D4(14), WG_D4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64, 64] += A[64, k16] x B, bf16, both from shared memory (descriptors)
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3),
        WG_D4(4), WG_D4(5), WG_D4(6), WG_D4(7)
      : "l"(da), "l"(db), "r"(1));
}

#undef WG_D4

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The lane's place: warpgroup q (its columns [64 q, 64 q + 64)), warp w in
// it (tile rows 16 w + g and 16 w + g + 8), g = lane / 4, t = lane % 4.
struct WgLane {
  int q, w, g, t;
  __device__ WgLane()
      : q(threadIdx.x >> 7), w((threadIdx.x >> 5) & 3), g((threadIdx.x >> 2) & 7),
        t(threadIdx.x & 3) {}
  __device__ int row(int e) const { return 16 * w + g + 8 * (e >> 1); }
};

// --- the weight ring ---------------------------------------------------------

constexpr int WG_NST = 4;   // weight ring slots (at most)
constexpr int WG_KSF = 16;  // k rows per f32 slab
constexpr int WG_KSB = 64;  // k rows per bf16 slab

// a slab of N columns takes 128 N bytes in either kind: KSF * N * (4 + 4)
// (f32 as TF32 hi | lo) = KSB * N * 2
__host__ __device__ constexpr int wg_slot(int N) { return 8 * WG_KSF * N; }
template <typename T>
__host__ __device__ constexpr int wg_ksf() { return sizeof(T) == 2 ? WG_KSB : WG_KSF; }

// The warpgroup's A fragments of slab s (k columns [s KS, (s + 1) KS)) from
// A [64][HC] in shared memory (bf16 [64][HC + 8] with BF: ah; else f32
// [64][HC + 4], split into TF32 hi ah and lo al): the mma.sync fragment of
// the warp's 16 rows, which wgmma takes from registers.
template <int HC, bool BF, int KK>
__device__ __forceinline__ void wg_a_frags(const char* sA, int s, const WgLane& ln,
                                           uint32_t (&ah)[KK][4], uint32_t (&al)[KK][4]) {
  constexpr int KS = BF ? WG_KSB : WG_KSF;
  const int r0 = 16 * ln.w + ln.g;
  if constexpr (BF) {
    const __nv_bfloat16* a = reinterpret_cast<const __nv_bfloat16*>(sA);
    constexpr int LD = HC + 8;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const __nv_bfloat16* p = a + r0 * LD + s * KS + 16 * kk + 2 * ln.t;
      ah[kk][0] = lds32(p);
      ah[kk][1] = lds32(p + 8 * LD);
      ah[kk][2] = lds32(p + 8);
      ah[kk][3] = lds32(p + 8 * LD + 8);
    }
  } else {
    const float* a = reinterpret_cast<const float*>(sA);
    constexpr int LD = HC + 4;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const float* p = a + r0 * LD + s * KS + 8 * kk + ln.t;
      split_tf32(p[0], ah[kk][0], al[kk][0]);
      split_tf32(p[8 * LD], ah[kk][1], al[kk][1]);
      split_tf32(p[4], ah[kk][2], al[kk][2]);
      split_tf32(p[8 * LD + 4], ah[kk][3], al[kk][3]);
    }
  }
}

}  // namespace
