// Hopper primitives shared by the warpgroup kernels of the PMA epilogue
// (pma_epilogue_wg.cu: K3a and K2 at HC 256; pma_epilogue_cluster.cu and
// pma_epilogue_cluster_bwd.cu: K2 and K3a at HC 384 and 512): mbarriers,
// bulk copies (the TMA's linear mode), wgmma with A from registers and B
// through a shared-memory descriptor, and the lane's place in a
// warpgroup's accumulator; and K3b, the dW partials over the transposed
// scratch, which every warpgroup K3 launches.

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

// --- K3b (HC 256 to 512) ----------------------------------------------------------

// part[run][ch][l] = h_l^T dp_l over the rows of chunk ch, from the
// transposed tables, as dW^T = dp^T h: a block takes a BJ (j) x BN (i)
// tile, each of its NWG warpgroups 64 j-rows of it against the same h
// rows, the chunk's rows KR at a time through cp.async stages. blockIdx.x
// = ((((run * nch + ch) * L + l) * (HC / BJ) + jt) * (HC / BN) + it): the
// tiles of one chunk run side by side and share its rows in L2.
template <typename T, int HC>
struct DwgPlan {
  static_assert(HC % 128 == 0, "128 x 128 tiles of dW");
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int NWG = 2;
  static constexpr int BJ = 64 * NWG;
  static constexpr int BN = 128;
  static constexpr int NTB = BN / 8;
  static constexpr int KR = F32 ? 16 : 32;        // rows per stage
  static constexpr int LDA = F32 ? KR + 4 : KR + 8;  // conflict-free fragments
  static constexpr int LDR = KR + 4;              // f32: the raw h rows' pitch
  static constexpr int A_BYTES = BJ * LDA * 4;
  static constexpr int B_PART = KR * BN * sizeof(T);  // one operand part, wgmma layout
  // a stage: dp rows, then h (bf16: in the wgmma layout; f32: raw [BN][LDR])
  static constexpr int STAGE = A_BYTES + (F32 ? BN * LDR * 4 : B_PART);
  static constexpr int HL = F32 ? 2 * B_PART : 0;  // f32: h's TF32 hi | lo, split per stage
  static constexpr int STAGES = 3;  // with two blocks an SM
  static constexpr int bytes = STAGES * STAGE + HL;
};

template <typename T, int HC>
__global__ void __launch_bounds__(128 * DwgPlan<T, HC>::NWG, 2)
    dw_wg_kernel(const T* __restrict__ hT, const float* __restrict__ dpT, int Mp, int L, int nch,
                 int chunk_rows, float* __restrict__ part) {
  using D = DwgPlan<T, HC>;
  constexpr int BJ = D::BJ, BN = D::BN, NTB = D::NTB, KR = D::KR, LDA = D::LDA, LDR = D::LDR;
  constexpr int NSTG = D::STAGES, NTH = 128 * D::NWG;
  constexpr int V = 16 / sizeof(T);  // rows per 16-byte chunk of h
  constexpr uint32_t LBO = BN * 16;  // bytes between the k chunks of B
  extern __shared__ __align__(128) char smem[];
  char* hl = smem + NSTG * D::STAGE;  // f32: the split h of the current stage
  int b = blockIdx.x;
  const int it = b % (HC / BN);
  b /= HC / BN;
  const int jt = b % (HC / BJ);
  b /= HC / BJ;
  const int l = b % L;
  b /= L;
  const int ch = b % nch, run = b / nch;
  const int i0 = it * BN, j0 = jt * BJ;
  const size_t off = ((size_t)run * L + l) * HC * Mp;
  hT += off, dpT += off;
  part += (((size_t)run * nch + ch) * L + l) * HC * HC;
  const int r_begin = ch * chunk_rows, r_end = min(Mp, r_begin + chunk_rows);
  const int nsteps = r_end > r_begin ? (r_end - r_begin + KR - 1) / KR : 0;
  const int q = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  auto load = [&](int st, int r0) {
    float* a = reinterpret_cast<float*>(smem + st * D::STAGE);
    char* bb = smem + st * D::STAGE + D::A_BYTES;
    for (int i = threadIdx.x; i < BJ * (KR / 4); i += NTH) {
      const int jj = i / (KR / 4), c = i % (KR / 4), r = r0 + 4 * c;
      cp16z(a + jj * LDA + 4 * c, dpT + (size_t)(j0 + jj) * Mp + (r < r_end ? r : r_begin),
            r < r_end);
    }
    for (int i = threadIdx.x; i < BN * (KR / V); i += NTH) {
      const int ii = i / (KR / V), kc = i % (KR / V), r = r0 + kc * V;
      const T* src = hT + (size_t)(i0 + ii) * Mp + (r < r_end ? r : r_begin);
      if constexpr (D::F32)
        cp16z(bb + (ii * LDR + kc * V) * 4, src, r < r_end);
      else
        cp16z(bb + kc * LBO + (ii >> 3) * 128 + (ii & 7) * 16, src, r < r_end);
    }
  };
  float acc[NTB][4];
#pragma unroll
  for (int j = 0; j < NTB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  fence_acc(acc);
#pragma unroll
  for (int s = 0; s < NSTG - 1; ++s) {
    if (s < nsteps) load(s, r_begin + s * KR);
    cp_commit();
  }
  const int jr = 64 * q + 16 * w + g;
#pragma unroll 1
  for (int st = 0; st < nsteps; ++st) {
    cp_wait<NSTG - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // stage st landed for all; every warp is done with st - 1
    const int nx = st + NSTG - 1;
    if (nx < nsteps) load(nx % NSTG, r_begin + nx * KR);
    cp_commit();
    const float* a = reinterpret_cast<const float*>(smem + (st % NSTG) * D::STAGE);
    const char* bb = smem + (st % NSTG) * D::STAGE + D::A_BYTES;
    if constexpr (sizeof(T) == 2) {
      // dp = d1 + d2 + d3 in bf16, three products with the bf16 h
      const uint32_t base = smem_u32(bb);
      uint32_t p1[KR / 16][4], p2[KR / 16][4], p3[KR / 16][4];
#pragma unroll
      for (int kk = 0; kk < KR / 16; ++kk) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 x = *reinterpret_cast<const float2*>(
              a + (jr + 8 * (u & 1)) * LDA + 16 * kk + 8 * (u >> 1) + 2 * t);
          const float xs[2] = {x.x, x.y};
          __nv_bfloat16 h1[2], h2[2], h3[2];
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            h1[v] = __float2bfloat16_rn(xs[v]);
            const float r1 = __fsub_rn(xs[v], __bfloat162float(h1[v]));
            h2[v] = __float2bfloat16_rn(r1);
            h3[v] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(h2[v])));
          }
          p1[kk][u] = pack_bf16(h1[0], h1[1]);
          p2[kk][u] = pack_bf16(h2[0], h2[1]);
          p3[kk][u] = pack_bf16(h3[0], h3[1]);
        }
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KR / 16; ++kk) {
        const uint64_t d = desc_k(base + 2 * kk * LBO, LBO, 128);
        wgmma_bf16(acc, p3[kk], d);
        wgmma_bf16(acc, p2[kk], d);
        wgmma_bf16(acc, p1[kk], d);
      }
    } else {
      // h's TF32 hi and lo parts into the wgmma layout, once per stage
      const float* raw = reinterpret_cast<const float*>(bb);
      for (int e = threadIdx.x; e < BN * KR; e += NTH) {
        const int kc = e / (BN * 4), ii = (e / 4) % BN, rr = e % 4;
        uint32_t hi, lo;
        split_tf32(raw[ii * LDR + kc * 4 + rr], hi, lo);
        const int o = kc * LBO + (ii >> 3) * 128 + (ii & 7) * 16 + rr * 4;
        *reinterpret_cast<uint32_t*>(hl + o) = hi;
        *reinterpret_cast<uint32_t*>(hl + D::B_PART + o) = lo;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const uint32_t base = smem_u32(hl);
      uint32_t ah[KR / 8][4], al[KR / 8][4];
#pragma unroll
      for (int kk = 0; kk < KR / 8; ++kk) {
        const float* p = a + jr * LDA + 8 * kk + t;
        split_tf32(p[0], ah[kk][0], al[kk][0]);
        split_tf32(p[8 * LDA], ah[kk][1], al[kk][1]);
        split_tf32(p[4], ah[kk][2], al[kk][2]);
        split_tf32(p[8 * LDA + 4], ah[kk][3], al[kk][3]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KR / 8; ++kk) {
        const uint64_t dh = desc_k(base + 2 * kk * LBO, LBO, 128);
        const uint64_t dl = desc_k(base + D::B_PART + 2 * kk * LBO, LBO, 128);
        wgmma_tf32(acc, al[kk], dh);
        wgmma_tf32(acc, ah[kk], dl);
        wgmma_tf32(acc, ah[kk], dh);
      }
    }
    wg_commit();
    wg_wait<0>();
    fence_acc(acc);
  }
  // acc holds dW^T[j][i]: write dW[i][j]
#pragma unroll
  for (int jj = 0; jj < NTB; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[(size_t)(i0 + 8 * jj + 2 * t + (e & 1)) * HC + j0 + jr + 8 * (e >> 1)] = acc[jj][e];
}

}  // namespace
