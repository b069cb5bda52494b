// The runs-folded f32 dense product: Y[:, r] = X[:, r] W_r (+ b_r) over a
// table of R runs [rows, R, K] (or an input [rows, K] the runs share), its
// input gradient dX[:, r] = dY[:, r] W_r^T and its parameter gradients
// dW_r = X[:, r]^T dY[:, r], db_r = the column sums of dY[:, r]. These are
// TorchDense's products and PMA's [lin_V | Wa] product (ops/cuda_dense.py).
// It replaces no TPU kernel: the JAX package leaves these products to XLA
// (vmapped over the runs). It replaces, on the card, one library GEMM per
// run on a contiguous copy of each run's slice, a bias pass per run and a
// stack of the runs' outputs, forward and backward.
//
// What bounds it on the H100: the products. The configurations state f32
// with TF32 off, so the library runs them on FMA units (67 TFLOP/s); here
// they run as 3xTF32 on the tensor cores (a*b ~ al*bh + ah*bl + ah*bh,
// x = hi + lo split by cvt.rna, the error argument of pma_epilogue.cuh),
// 495/3 TFLOP/s, and read each table once in place. The design:
//   * the products (runs_dense_mm_kernel, forward and dX): one persistent
//     block per SM walks work items (run, 128-row tile, column tile of up
//     to 136 columns: TN = 8 NP, NP in {2, 8, 16, 17}), the column tiles of
//     a row tile side by side (its activations come from L2 after the
//     first). A producer thread (its warpgroup hands its
//     registers to the consumers' by setmaxnreg) keeps a ring of stages
//     full: per 32 k-columns, the 128 rows' activations by one TMA tensor
//     copy out of the folded table (a 3-D tensor map over [rows, R, K],
//     with R = 1 for a shared input; 128-byte swizzle, zeros past the
//     rows and past K) and the run's weight stage by one bulk copy, laid
//     out by runs_dense_slabs_kernel as wgmma's K-major core matrices of
//     TF32 hi | lo. Two consumer warpgroups, 64 rows each, split their
//     activation fragments into hi and lo in registers and run the three
//     products per k8 step, as pieces of 128, 64, 32, 16 and 8 columns.
//     The tensor cores round their f32 sums toward zero, so ah*bh goes to
//     one accumulator and the two small terms to another, added at the
//     end: the large sum takes a third of the roundings (one accumulator
//     for all three erred 2.5x as much as the library's f32 product at K
//     100). That is 8 NP floats a thread twice, hence the tile's 136
//     columns. The epilogue adds the bias from registers and stores into
//     [rows, R, N] with masks: any N, no stack, no bias pass;
//   * dW and db (runs_dense_dw_kernel): items (run, row chunk, 128-column
//     tile of K, column tile of N); the chunks depend on the rows alone,
//     so no sum depends on R. The same producer ring brings 32 rows of X
//     and of dY per stage; the consumers write dY's rows transposed into
//     K-major core matrices of TF32 hi | lo (the split pass that rewrites
//     every element anyway does the transpose: TF32 wgmma reads K-major
//     operands only), in two buffers, the next stage's while this stage's
//     products run; they read X's fragments transposed into registers, and
//     the column-tile-0 items add db's column sums over the same stages.
//     Each stage's products start from zero and are added into the item's
//     total with round-to-nearest: a truncating sum never runs longer than
//     32 rows;
//   * runs_dense_reduce_kernel adds each run's partials over the chunks in
//     order, compensated (so do the column sums of db over the stages). No
//     floating-point atomics: two calls give the same bits, and a run gives
//     the same bits alone or folded with others.

#include <cuda.h>

#include "pma_wgmma.cuh"

namespace {

constexpr int RD_TM = 128;  // rows per product item: two consumer warpgroups of 64
constexpr int RD_KA = 32;   // k-columns per stage: one 128-byte swizzled row
constexpr int RD_KR = 32;   // rows per dW stage
constexpr int RD_CONS = 2;  // consumer warpgroups
constexpr int RD_THREADS = 128 * (RD_CONS + 1);

// --- wgmma m64nNk8 tf32, A from registers, into columns [8 O, 8 (O + W)) of d ---

#define RD_D(j) "+f"(d[O + j][0]), "+f"(d[O + j][1]), "+f"(d[O + j][2]), "+f"(d[O + j][3])
template <int O, int NP>
__device__ __forceinline__ void rd_n8(float (&d)[NP][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : RD_D(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <int O, int NP>
__device__ __forceinline__ void rd_n16(float (&d)[NP][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : RD_D(0), RD_D(1)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <int O, int NP>
__device__ __forceinline__ void rd_n32(float (&d)[NP][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : RD_D(0), RD_D(1), RD_D(2), RD_D(3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <int O, int NP>
__device__ __forceinline__ void rd_n64(float (&d)[NP][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : RD_D(0), RD_D(1), RD_D(2), RD_D(3), RD_D(4), RD_D(5), RD_D(6), RD_D(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <int O, int NP>
__device__ __forceinline__ void rd_n128(float (&d)[NP][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : RD_D(0), RD_D(1), RD_D(2), RD_D(3), RD_D(4), RD_D(5), RD_D(6), RD_D(7), RD_D(8),
        RD_D(9), RD_D(10), RD_D(11), RD_D(12), RD_D(13), RD_D(14), RD_D(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef RD_D

// d[64, 8 NP] += A[64, k8] x B over the columns [8 O, 8 NP) as pieces of
// 128, 64, 32, 16 and 8: B's K-major core matrices at b (one 128-byte
// core matrix per 8 columns), lbo bytes between its k-chunks
template <int O, int NP>
__device__ __forceinline__ void rd_products(float (&d)[NP][4], const uint32_t (&a)[4], uint32_t b,
                                            uint32_t lbo) {
  if constexpr (O < NP) {
    constexpr int R = NP - O;
    const uint64_t db = desc_k(b + O * 128, lbo, 128);
    if constexpr (R >= 16) {
      rd_n128<O>(d, a, db);
      rd_products<O + 16>(d, a, b, lbo);
    } else if constexpr (R >= 8) {
      rd_n64<O>(d, a, db);
      rd_products<O + 8>(d, a, b, lbo);
    } else if constexpr (R >= 4) {
      rd_n32<O>(d, a, db);
      rd_products<O + 4>(d, a, b, lbo);
    } else if constexpr (R >= 2) {
      rd_n16<O>(d, a, db);
      rd_products<O + 2>(d, a, b, lbo);
    } else {
      rd_n8<O>(d, a, db);
    }
  }
}

// a box of the tensor map at coordinates (c0 innermost) into dst, completing on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}

// the consumer warpgroups' own barrier (the producer warpgroup has left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * RD_CONS) : "memory");
}

// 1024 bytes into the dynamic shared memory: the 128-byte swizzle's atom
__device__ __forceinline__ char* rd_smem(char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// The ring's handshake: full[s] completes when stage s has landed (the
// producer's expect_tx and the copies' bytes); empty[s] when each of the
// consumers' eight warps has released it.
__device__ __forceinline__ void rd_init_ring(uint64_t* full, uint64_t* empty, int nst) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < nst; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], RD_CONS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// --- the products: forward and dX ---------------------------------------------

// both accumulators of a thread, zeroed
template <int NP>
__device__ __forceinline__ void rd_zero(float (&big)[NP][4], float (&small)[NP][4]) {
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) big[j][e] = small[j][e] = 0.f;
  fence_acc(big);
  fence_acc(small);
}

// one k8 step of the 3xTF32 product: the small terms al*bh and ah*bl into
// small, ah*bh into big
template <int NP>
__device__ __forceinline__ void rd_step(float (&big)[NP][4], float (&small)[NP][4],
                                        const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                        uint32_t bh, uint32_t bl, uint32_t lbo) {
  rd_products<0>(small, al, bh, lbo);
  rd_products<0>(small, ah, bl, lbo);
  rd_products<0>(big, ah, bh, lbo);
}

template <int NP>
struct MmPlan {
  static constexpr int TN = 8 * NP;
  static constexpr int A_BYTES = RD_TM * 128;    // 128 rows x 32 f32
  static constexpr int B_BYTES = RD_KA * TN * 8;  // two 16-row slabs, TF32 hi | lo each
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int FIT = (int)((SMEM_MAX - 2048) / STAGE);
  static constexpr int NST = FIT > 4 ? 4 : FIT;
  static constexpr int bytes = NST * STAGE + 2 * NST * 8 + 1024;  // + alignment
  static_assert(NST >= 2, "a ring of two stages at least");
};

struct MmArgs {
  const char* B;      // [R, ntn, nk, B_BYTES]: the weight stages (runs_dense_slabs_kernel)
  const float* bias;  // [R, N] or null
  float* C;           // element (m, r, n) at C[m ldc + r N + n]
  long long ldc;
  int rows, R, N, nk, ntn, shared;
};

template <int NP>
__global__ void __launch_bounds__(RD_THREADS, 1)
    runs_dense_mm_kernel(const __grid_constant__ CUtensorMap ta, const MmArgs g) {
  using P = MmPlan<NP>;
  constexpr int NST = P::NST, TN = P::TN;
  constexpr uint32_t LBO = TN * 16;  // bytes between the k-chunks of a slab
  extern __shared__ __align__(128) char smem_raw[];
  char* smem = rd_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NST * P::STAGE);
  uint64_t* empty = full + NST;
  const int ntm = (g.rows + RD_TM - 1) / RD_TM;
  const long long nitems = (long long)g.R * ntm * g.ntn;
  rd_init_ring(full, empty, NST);
  if (threadIdx.x >= 128 * RD_CONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 128 * RD_CONS) return;  // one thread starts the copies
    uint32_t it = 0;
    for (long long item = blockIdx.x; item < nitems; item += gridDim.x) {
      const int tn = (int)(item % g.ntn);
      const long long rest = item / g.ntn;
      const int tm = (int)(rest % ntm), run = (int)(rest / ntm);
      const char* b = g.B + ((size_t)run * g.ntn + tn) * g.nk * (size_t)P::B_BYTES;
      for (int s = 0; s < g.nk; ++s, ++it) {
        const uint32_t slot = it % NST;
        if (it >= (uint32_t)NST) mbar_wait(&empty[slot], ((it / NST) - 1) & 1);
        char* st = smem + slot * P::STAGE;
        mbar_expect_tx(&full[slot], P::STAGE);
        tma_load_3d(st, &ta, s * RD_KA, g.shared ? 0 : run, tm * RD_TM, &full[slot]);
        bulk_load(st + P::A_BYTES, b + (size_t)s * P::B_BYTES, P::B_BYTES, &full[slot]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const WgLane ln;  // q: the consumer warpgroup, its rows [64 q, 64 q + 64)
  const int r0 = 64 * ln.q + 16 * ln.w + ln.g;
  const bool vec2 = (g.N & 1) == 0 && (g.ldc & 1) == 0;
  uint32_t it = 0;
  for (long long item = blockIdx.x; item < nitems; item += gridDim.x) {
    const int tn = (int)(item % g.ntn);
    const long long rest = item / g.ntn;
    const int tm = (int)(rest % ntm), run = (int)(rest / ntm);
    float acc[NP][4], acs[NP][4];
    rd_zero(acc, acs);
#pragma unroll 1
    for (int s = 0; s < g.nk; ++s, ++it) {
      const uint32_t slot = it % NST;
      mbar_wait(&full[slot], (it / NST) & 1);
      const char* st = smem + slot * P::STAGE;
      // rows r0 and r0 + 8, whose low three bits are g: chunk c of a row
      // lies at chunk c ^ g (the 128-byte swizzle)
      const float* a = reinterpret_cast<const float*>(st) + r0 * RD_KA + ln.t;
      uint32_t ah[RD_KA / 8][4], al[RD_KA / 8][4];
#pragma unroll
      for (int kk = 0; kk < RD_KA / 8; ++kk) {
        const float* p0 = a + ((2 * kk) ^ ln.g) * 4;
        const float* p1 = a + ((2 * kk + 1) ^ ln.g) * 4;
        split_tf32(p0[0], ah[kk][0], al[kk][0]);
        split_tf32(p0[8 * RD_KA], ah[kk][1], al[kk][1]);
        split_tf32(p1[0], ah[kk][2], al[kk][2]);
        split_tf32(p1[8 * RD_KA], ah[kk][3], al[kk][3]);
      }
      const uint32_t bb = smem_u32(st + P::A_BYTES);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < RD_KA / 8; ++kk) {
        // slab kk / 2 (hi, then lo 16 TN floats on), its k8 step kk % 2
        const uint32_t bh = bb + (kk >> 1) * (16 * TN * 8) + (kk & 1) * 2 * LBO;
        rd_step(acc, acs, ah[kk], al[kk], bh, bh + 16 * TN * 4, LBO);
      }
      wg_commit();
      wg_wait<0>();
      fence_acc(acc);
      fence_acc(acs);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[slot]);
    }
    // the epilogue: element (j, e) of acc is row 16 w + g + 8 (e / 2) of
    // the warpgroup's 64, column 8 j + 2 t + e % 2 of the tile
    const float* bias = g.bias ? g.bias + (size_t)run * g.N : nullptr;
    const int col0 = tn * TN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = tm * RD_TM + r0 + 8 * h;
      if (m >= g.rows) continue;
      float* c = g.C + (size_t)m * g.ldc + (size_t)run * g.N;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int col = col0 + 8 * j + 2 * ln.t;
        float v0 = __fadd_rn(acc[j][2 * h], acs[j][2 * h]);
        float v1 = __fadd_rn(acc[j][2 * h + 1], acs[j][2 * h + 1]);
        if (bias) {
          if (col < g.N) v0 = __fadd_rn(v0, __ldg(bias + col));
          if (col + 1 < g.N) v1 = __fadd_rn(v1, __ldg(bias + col + 1));
        }
        if (vec2) {
          if (col < g.N) *reinterpret_cast<float2*>(c + col) = make_float2(v0, v1);
        } else {
          if (col < g.N) c[col] = v0;
          if (col + 1 < g.N) c[col + 1] = v1;
        }
      }
    }
  }
}

// --- dW and db: partials over row chunks, then their reduce -------------------------

template <int NP>
struct DwPlanRD {
  static constexpr int TN = 8 * NP;
  static constexpr int NB = (TN + 31) / 32;       // dY's boxes of 32 columns a stage
  static constexpr int X_BYTES = 4 * RD_KR * 128;  // X: 128 columns, 4 boxes
  static constexpr int Y_BYTES = NB * RD_KR * 128;
  static constexpr int STAGE = X_BYTES + Y_BYTES;
  static constexpr int PART = RD_KR * TN * 4;  // one TF32 part of dY^T, K-major
  static constexpr int HL = 2 * PART;  // a buffer: hi | lo
  static constexpr int FIT = (int)((SMEM_MAX - 2 * HL - 2048) / STAGE);
  static constexpr int NST = FIT > 4 ? 4 : FIT;
  static constexpr int bytes = NST * STAGE + 2 * HL + 2 * NST * 8 + 1024;  // + alignment
  static_assert(NST >= 2, "a ring of two stages at least");
};

struct DwArgs {
  float* part;    // [R, nch, K, N]
  float* part_b;  // [R, nch, N] or null
  int rows, R, K, N, nch, chunk_rows, ntk, ntn, xshared;
};

// element (row, col) of a stage's 32-column box b (RD_KR rows of 128
// bytes, 128-byte swizzle)
__device__ __forceinline__ int rd_box(int b, int row, int col) {
  return b * (RD_KR * 32) + row * 32 + (((col >> 2) ^ (row & 7)) << 2) + (col & 3);
}

// s + c += x, compensated (Neumaier): the sum is s + c
__device__ __forceinline__ void rd_add(float& s, float& c, float x) {
  const float t = __fadd_rn(s, x);
  c = __fadd_rn(c, fabsf(s) >= fabsf(x) ? __fadd_rn(__fsub_rn(s, t), x)
                                        : __fadd_rn(__fsub_rn(x, t), s));
  s = t;
}

// a stage's column col summed over its RD_KR rows: four runs of 8 rows,
// then their pairs
__device__ __forceinline__ float rd_col_sum(const float* ys, int col) {
  float p[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    p[q] = 0.f;
#pragma unroll
    for (int r = 8 * q; r < 8 * q + 8; ++r)
      p[q] = __fadd_rn(p[q], ys[rd_box(col >> 5, r, col & 31)]);
  }
  return __fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3]));
}

template <int NP>
__global__ void __launch_bounds__(RD_THREADS, 1)
    runs_dense_dw_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap ty, const DwArgs g) {
  using P = DwPlanRD<NP>;
  constexpr int NST = P::NST, TN = P::TN, NB = P::NB;
  constexpr uint32_t LBO = TN * 16;
  constexpr int NTH = 128 * RD_CONS;
  extern __shared__ __align__(128) char smem_raw[];
  char* smem = rd_smem(smem_raw);
  char* hl = smem + NST * P::STAGE;  // two buffers of dY^T's TF32 hi | lo, K-major
  uint64_t* full = reinterpret_cast<uint64_t*>(hl + 2 * P::HL);
  uint64_t* empty = full + NST;
  // item = ((run nch + ch) ntn + tn) ntk + tk: the K tiles of one chunk side by side
  const long long nitems = (long long)g.R * g.nch * g.ntn * g.ntk;
  rd_init_ring(full, empty, NST);
  auto unpack = [&](long long item, int& run, int& ch, int& tn, int& tk) {
    tk = (int)(item % g.ntk);
    item /= g.ntk;
    tn = (int)(item % g.ntn);
    item /= g.ntn;
    ch = (int)(item % g.nch);
    run = (int)(item / g.nch);
  };
  auto steps = [&](int ch) {
    const int r0 = ch * g.chunk_rows, r1 = min(g.rows, r0 + g.chunk_rows);
    return (r1 - r0 + RD_KR - 1) / RD_KR;
  };
  if (threadIdx.x >= NTH) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != NTH) return;
    uint32_t it = 0;
    for (long long item = blockIdx.x; item < nitems; item += gridDim.x) {
      int run, ch, tn, tk;
      unpack(item, run, ch, tn, tk);
      const int ns = steps(ch);
      for (int s = 0; s < ns; ++s, ++it) {
        const uint32_t slot = it % NST;
        if (it >= (uint32_t)NST) mbar_wait(&empty[slot], ((it / NST) - 1) & 1);
        char* st = smem + slot * P::STAGE;
        const int row = ch * g.chunk_rows + s * RD_KR;
        mbar_expect_tx(&full[slot], P::STAGE);
        for (int b = 0; b < 4; ++b)
          tma_load_3d(st + b * RD_KR * 128, &tx, tk * 128 + 32 * b, g.xshared ? 0 : run, row,
                      &full[slot]);
        for (int b = 0; b < NB; ++b)
          tma_load_3d(st + P::X_BYTES + b * RD_KR * 128, &ty, tn * TN + 32 * b, run, row,
                      &full[slot]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const WgLane ln;
  const int m0 = 64 * ln.q + 16 * ln.w + ln.g;  // the thread's rows of dW's tile: m0, m0 + 8
  const int tid = threadIdx.x;
  uint32_t it = 0;
  for (long long item = blockIdx.x; item < nitems; item += gridDim.x) {
    int run, ch, tn, tk;
    unpack(item, run, ch, tn, tk);
    const int ns = steps(ch);
    const bool sums = g.part_b != nullptr && tk == 0;
    // db: columns tid and tid + NTH of the tile, compensated sums of the
    // stages' column sums (a plain running sum over a chunk's rows and then
    // over the chunks erred 10x as much as torch.sum)
    float cs0 = 0.f, cc0 = 0.f, cs1 = 0.f, cc1 = 0.f;
    // acc: a stage's products (the tensor cores' truncating sums over its
    // 32 rows); tot: the stages' sum, rounded to nearest (one accumulator
    // over a chunk's thousands of rows erred 8x as much as the library's
    // f32 product)
    float acc[NP][4], tot[NP][4];
    rd_zero(acc, tot);
    uint32_t ah[RD_KR / 8][4], al[RD_KR / 8][4];
    // stage s of the item: wait for it, write dY's rows transposed into
    // K-major core matrices of hi | lo in buffer s % 2 (lanes take 4
    // consecutive rows x 8 consecutive columns: conflict-free stores), add
    // db's column sums over its rows in row order
    auto split = [&](int s) {
      const uint32_t n = it + s, slot = n % NST;
      mbar_wait(&full[slot], (n / NST) & 1);
      const float* ys = reinterpret_cast<const float*>(smem + slot * P::STAGE + P::X_BYTES);
      char* h = hl + (s & 1) * P::HL;
      for (int e = tid; e < TN * RD_KR; e += NTH) {
        const int kc = e / (TN * 4), ii = (e >> 2) % TN, rr = e & 3, row = 4 * kc + rr;
        uint32_t hi, lo;
        split_tf32(ys[rd_box(ii >> 5, row, ii & 31)], hi, lo);
        const int o = kc * LBO + (ii >> 3) * 128 + (ii & 7) * 16 + rr * 4;
        *reinterpret_cast<uint32_t*>(h + o) = hi;
        *reinterpret_cast<uint32_t*>(h + P::PART + o) = lo;
      }
      if (sums) {
        if (tid < TN) rd_add(cs0, cc0, rd_col_sum(ys, tid));
        if (tid + NTH < TN) rd_add(cs1, cc1, rd_col_sum(ys, tid + NTH));
      }
    };
    // stage s's X fragments, transposed (A[m][k] = X[row k][column m]);
    // then the split is made visible to the products and the raw stage
    // goes back to the producer
    auto frags = [&](int s) {
      const uint32_t slot = (it + s) % NST;
      const float* xs = reinterpret_cast<const float*>(smem + slot * P::STAGE);
#pragma unroll
      for (int kk = 0; kk < RD_KR / 8; ++kk) {
        const int k0 = 8 * kk + ln.t;
        split_tf32(xs[rd_box(m0 >> 5, k0, m0 & 31)], ah[kk][0], al[kk][0]);
        split_tf32(xs[rd_box((m0 + 8) >> 5, k0, (m0 + 8) & 31)], ah[kk][1], al[kk][1]);
        split_tf32(xs[rd_box(m0 >> 5, k0 + 4, m0 & 31)], ah[kk][2], al[kk][2]);
        split_tf32(xs[rd_box((m0 + 8) >> 5, k0 + 4, (m0 + 8) & 31)], ah[kk][3], al[kk][3]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // every split of stage s is whole, and every warpgroup is done with
      // the products that read its buffer two stages ago
      consumers_sync();
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[slot]);
    };
    split(0);
    frags(0);
    // stage s's products run while stage s + 1 is split
#pragma unroll 1
    for (int s = 0; s < ns; ++s) {
      const uint32_t base = smem_u32(hl + (s & 1) * P::HL);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < RD_KR / 8; ++kk) {
        const uint32_t bh = base + 2 * kk * LBO;
        rd_products<0>(acc, al[kk], bh, LBO);
        rd_products<0>(acc, ah[kk], bh + P::PART, LBO);
        rd_products<0>(acc, ah[kk], bh, LBO);
      }
      wg_commit();
      if (s + 1 < ns) split(s + 1);
      wg_wait<0>();
      fence_acc(acc);
#pragma unroll
      for (int j = 0; j < NP; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot[j][e] = __fadd_rn(tot[j][e], acc[j][e]);
          acc[j][e] = 0.f;
        }
      fence_acc(acc);
      if (s + 1 < ns) frags(s + 1);
    }
    it += ns;
    // acc: dW[tk 128 + m][tn TN + n], element (j, e) at m = m0 + 8 (e / 2),
    // n = 8 j + 2 t + e % 2
    float* part = g.part + ((size_t)run * g.nch + ch) * g.K * g.N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = tk * 128 + m0 + 8 * h;
      if (m >= g.K) continue;
#pragma unroll
      for (int j = 0; j < NP; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = tn * TN + 8 * j + 2 * ln.t + q;
          if (n < g.N) part[(size_t)m * g.N + n] = tot[j][2 * h + q];
        }
    }
    if (sums) {
      float* pb = g.part_b + ((size_t)run * g.nch + ch) * g.N + tn * TN;
      if (tid < TN && tn * TN + tid < g.N) pb[tid] = __fadd_rn(cs0, cc0);
      if (tid + NTH < TN && tn * TN + tid + NTH < g.N) pb[tid + NTH] = __fadd_rn(cs1, cc1);
    }
  }
}

// dW[r] (then db[r] after it) = the sum of run r's partials over the
// chunks, in chunk order, compensated
__global__ void __launch_bounds__(256)
    runs_dense_reduce_kernel(const float* __restrict__ part, const float* __restrict__ part_b,
                             float* __restrict__ dW, float* __restrict__ db, int nch,
                             long long per, int N) {
  const int run = blockIdx.y;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i < per) {
    const float* p = part + (size_t)run * nch * per + i;
    float s = 0.f, c = 0.f;
    for (int k = 0; k < nch; ++k) rd_add(s, c, p[(size_t)k * per]);
    dW[(size_t)run * per + i] = __fadd_rn(s, c);
  } else if (db != nullptr && i < per + N) {
    const float* p = part_b + (size_t)run * nch * N + (i - per);
    float s = 0.f, c = 0.f;
    for (int k = 0; k < nch; ++k) rd_add(s, c, p[(size_t)k * N]);
    db[(size_t)run * N + (i - per)] = __fadd_rn(s, c);
  }
}

// --- the weight stages ---------------------------------------------------------

// B_r [Nn, Kk] (element (n, k) at src[r sr + n sn + k sk]: column n of the
// product's right operand) as the products' stages: per run and column
// tile of TN, Kp / 16 slabs of 16 k-rows, each TF32 hi then lo, as
// 8 x 16-byte core matrices [4 k-chunks][TN / 8][8][4] (wgmma's K-major
// layout without swizzle); zeros past Nn and Kk
__global__ void __launch_bounds__(256)
    runs_dense_slabs_kernel(const float* __restrict__ src, long long sr, long long sn,
                            long long sk, int Nn, int Kk, int TN, int ntn, int Kp,
                            float* __restrict__ out, long long total) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= total) return;
  long long i = idx;
  const int v = (int)(i & 3);
  i >>= 2;
  const int row8 = (int)(i & 7);
  i >>= 3;
  const int ng = (int)(i % (TN / 8));
  i /= TN / 8;
  const int kc = (int)(i & 3);
  i >>= 2;
  const int s = (int)(i % (Kp / 16));
  i /= Kp / 16;
  const int tn = (int)(i % ntn);
  const int r = (int)(i / ntn);
  const int n = tn * TN + 8 * ng + row8, k = 16 * s + 4 * kc + v;
  const float x = n < Nn && k < Kk ? src[r * sr + n * sn + k * sk] : 0.f;
  uint32_t hi, lo;
  split_tf32(x, hi, lo);
  float* o = out + (((size_t)r * ntn + tn) * (Kp / 16) + s) * 32 * TN + (size_t)kc * 4 * TN +
             ng * 32 + row8 * 4 + v;
  o[0] = __uint_as_float(hi);
  o[16 * TN] = __uint_as_float(lo);
}

// --- host side ----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda's entry point), fetched through the runtime: no link to libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over f32 [rows, mid, inner] (contiguous, inner % 4 == 0, a
// 16-byte aligned base): boxes of 32 x 1 x box_rows, 128-byte swizzle,
// zeros out of bounds
bool rd_map(CUtensorMap* m, const void* base, int inner, int mid, int rows, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)mid, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 4, (cuuint64_t)inner * mid * 4};
  const cuuint32_t box[3] = {32, 1, (cuuint32_t)box_rows};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int rd_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <int NP>
int launch_mm(const CUtensorMap& ta, const MmArgs& g, cudaStream_t s) {
  using P = MmPlan<NP>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        runs_dense_mm_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::bytes);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const long long nitems = (long long)g.R * ((g.rows + RD_TM - 1) / RD_TM) * g.ntn;
  const int grid = (int)(nitems < rd_sms() ? nitems : rd_sms());
  runs_dense_mm_kernel<NP><<<grid, RD_THREADS, P::bytes, s>>>(ta, g);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_dw(const CUtensorMap& tx, const CUtensorMap& ty, const DwArgs& g, cudaStream_t s) {
  using P = DwPlanRD<NP>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        runs_dense_dw_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::bytes);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const long long nitems = (long long)g.R * g.nch * g.ntn * g.ntk;
  const int grid = (int)(nitems < rd_sms() ? nitems : rd_sms());
  runs_dense_dw_kernel<NP><<<grid, RD_THREADS, P::bytes, s>>>(tx, ty, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The weight stages of the products (runs_dense_slabs_kernel) into out
// [R, ntn, Kp / 16, 2, 16 TN] f32.
int allset_runs_dense_slabs(const void* src, long long sr, long long sn, long long sk, int R,
                            int Nn, int Kk, int TN, int ntn, int Kp, void* out, void* stream) {
  const long long total = (long long)R * ntn * Kp * TN;
  if (total <= 0) return (int)cudaGetLastError();
  runs_dense_slabs_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                            reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), sr, sn, sk, Nn, Kk, TN, ntn, Kp, static_cast<float*>(out),
      total);
  return (int)cudaGetLastError();
}

// C[m, r, :N] = A[m, r or 0, :] B_r (+ bias[r]) for every run: A f32 [rows,
// Ra, Ka] contiguous (Ra = 1: shared by the runs; Ka % 4 == 0), B the
// stages of allset_runs_dense_slabs (nk = Kp / 32 of them per column
// tile), C with row stride ldc. np: the column tile's 8-column chunks (2,
// 8, 16 or 17).
int allset_runs_dense_mm(const void* A, int rows, int Ra, int Ka, const void* B, const void* bias,
                         void* C, long long ldc, int R, int N, int nk, int ntn, int np,
                         void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (rows <= 0 || R <= 0) return (int)cudaGetLastError();
  CUtensorMap ta;
  if (!rd_map(&ta, A, Ka, Ra, rows, RD_TM)) return (int)cudaErrorInvalidValue;
  MmArgs g;
  g.B = static_cast<const char*>(B);
  g.bias = static_cast<const float*>(bias);
  g.C = static_cast<float*>(C);
  g.ldc = ldc;
  g.rows = rows, g.R = R, g.N = N, g.nk = nk, g.ntn = ntn, g.shared = Ra == 1 && R > 1;
  switch (np) {
    case 2: return launch_mm<2>(ta, g, s);
    case 8: return launch_mm<8>(ta, g, s);
    case 16: return launch_mm<16>(ta, g, s);
    case 17: return launch_mm<17>(ta, g, s);
  }
  return (int)cudaErrorInvalidValue;
}

// dW [R, K, N] = X_r^T dY_r and, with db, db [R, N] = the column sums of
// dY_r: X f32 [rows, Rx, Kx] (Rx = 1: shared; Kx >= K, Kx % 4 == 0), dY f32
// [rows, R, Ny] (Ny >= N, Ny % 4 == 0), both contiguous; partials part
// [R, nch, K, N] and part_b [R, nch, N] over chunks of chunk_rows rows
// (a multiple of 32), then their reduce: two launches.
int allset_runs_dense_dw(const void* X, int Rx, int Kx, const void* dY, int Ny, int rows, int R,
                         int K, int N, int np, int ntn, int nch, int chunk_rows, void* part,
                         void* part_b, void* dW, void* db, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (rows <= 0 || R <= 0) return (int)cudaGetLastError();
  CUtensorMap tx, ty;
  if (!rd_map(&tx, X, Kx, Rx, rows, RD_KR) || !rd_map(&ty, dY, Ny, R, rows, RD_KR))
    return (int)cudaErrorInvalidValue;
  DwArgs g;
  g.part = static_cast<float*>(part);
  g.part_b = db != nullptr ? static_cast<float*>(part_b) : nullptr;
  g.rows = rows, g.R = R, g.K = K, g.N = N, g.nch = nch, g.chunk_rows = chunk_rows;
  g.ntk = (K + 127) / 128, g.ntn = ntn, g.xshared = Rx == 1 && R > 1;
  int rc = (int)cudaErrorInvalidValue;
  switch (np) {
    case 2: rc = launch_dw<2>(tx, ty, g, s); break;
    case 8: rc = launch_dw<8>(tx, ty, g, s); break;
    case 16: rc = launch_dw<16>(tx, ty, g, s); break;
    case 17: rc = launch_dw<17>(tx, ty, g, s); break;
  }
  if (rc != 0) return rc;
  const long long per = (long long)K * N;
  const long long cols = per + (db != nullptr ? N : 0);
  runs_dense_reduce_kernel<<<dim3((unsigned)((cols + 255) / 256), R), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(part_b), static_cast<float*>(dW),
      static_cast<float*>(db), nch, per, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
