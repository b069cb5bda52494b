// K2 / K3: the fused PMA epilogue, forward and backward: the code and the
// design both share (K2 is built from pma_epilogue_fwd.cu, K3 from
// pma_epilogue.cu).
//
// Replaces allset_tpu/ops/pallas_pma.py::_fwd_kernel (K2) and ::_bwd_kernel
// (K3), and their runs grids (K2R, K3R: the R > 1 pallas_calls of
// _pallas_fwd/_pallas_bwd). Per row of the packed aggregate
// agg = [vals HC | den H | pad]:
//   out0 = vals / expand(max(den, 1e-16)) + seed
//   z    = LN0(out0)            f32, fast variance E[x^2] - mu^2, eps 1e-5
//   zb   = z rounded to the activation dtype
//   p_l  = round(round(h_l @ W_l) + b_l)   L in {1, 2}; h_0 = zb,
//          h_1 = round(relu(p_0))          (TorchDense rounding points)
//   y    = LN1(zb + relu(p_L-1)), rounded, optionally relu'd
//
// What bounds it on the H100: the rFF products. K3 runs six [rows, HC] x
// [HC, HC] products per row at L = 2 (two forward, two dp @ W^T, two
// h^T dp), 786K flops per row at HC = 256, against ~2 KB of row traffic.
// The design:
//   * a tile of TM = 32 MT rows per block iteration, 16 warps in two
//     groups of 8; group q owns rows [16 MT q, 16 MT (q + 1)), warp w of a
//     group the columns [w*HC/8, (w+1)*HC/8), and each warp keeps its
//     [16 MT, HC/8] share of every intermediate in registers in the mma
//     accumulator layout. MT = 2 (64 rows) (with four m-tiles 8 warps
//     needed 255 registers and spilled; HC 384 and 512 run on the cluster
//     kernels, pma_epilogue_cluster*.cu). Row
//     statistics (LN means, the LN backward's row sums) are
//     per-warp partial sums exchanged through shared memory in a fixed
//     order. The tile's agg rows are staged in shared memory once
//     (cp.async, 16 bytes), read there by the three passes that need
//     out0, and y (K2) or dagg (K3) leave through the same buffer in
//     16-byte rows. Where the H denominators would overflow shared memory
//     (f32 only: K2 from 192 heads at HC 192; f32 K2 at HC 256 runs
//     beside K3a, K2 at 384 and 512 on a cluster; K3 here, at HC 192 or
//     less, never), a second instantiation (DG) stages
//     only the values and reads den from global memory, writing dden
//     straight out; the A operand of
//     the next product ([TM, HC], 66.5 KB at HC = 256 f32) lives in shared
//     memory;
//   * every rFF product runs on the tensor cores with mma.sync. Operands
//     exactly in bf16 (zb, round(relu(p0)) and the bf16 weights on the
//     bf16 path) use m16n8k16 bf16 with f32 accumulation. The products the
//     JAX package takes in f32 (the f32 path's forward, dp @ W^T, h^T dp)
//     use 3xTF32 on m16n8k8: x = hi + lo with hi = tf32(x) (cvt.rna, 11
//     significant bits) and lo = tf32(x - hi); a*b ~ al*bh + ah*bl + ah*bh.
//     |x - hi - lo| <= 2^-22 |x| and the dropped al*bl <= 2^-22 |a b|, so
//     each product term is within ~3 * 2^-22 (7e-7) of a*b and a dot
//     product within ~1e-6 of sum |a_k b_k|, the f32 matmul's own order of
//     error (tests/test_torch_pma.py emulates the split). Where A is exact
//     in TF32 (a bf16 h in h^T dp), 2xTF32: ah*bl + ah*bh;
//   * the weights pass through shared memory in slabs (KS_F k-rows in
//     f32, KS_B = 2 KS_F k-columns in bf16, the same bytes; KS_F = 32, 37
//     KB at HC = 256), two stages: the whole block copies slab s + 1 with
//     cp.async while its warps multiply with slab s. From HC = 256 a
//     layer's weights (128 KB in bf16, 256 KB in f32) do not fit beside
//     the tile, so they stream from L2 once per tile (4 KB per row and
//     product at f32, HC 256);
//   * the widths and their tiles, with K3's bytes of shared memory at 8
//     heads in f32 (A operand, row exchange and statistics, column sums;
//     two weight stages; staged agg rows) against the 232,448 a block may
//     take: HC 64-256 TM 64, KS_F 32 (HC 256: 87,808 + 73,728 + 67,584 =
//     229,120; from 32 heads the staged rows overflow, DG). K2 needs no column sums and
//     keeps its A operand in the tile's agg buffer (next note), so it
//     takes KS_B 128 in bf16 at HC 128 and 256 (half the barriers;
//     211,728 B at HC 256);
//   * the rounding points of _fwd_recompute are kept; the additions that
//     feed a rounding (out0, LN) use explicit _rn intrinsics, so the
//     forward and the backward's recompute round alike.
//
// K2, the forward, is a kernel of its own: one persistent block per SM
// walks the (run, tile) items. Its shared memory holds the row exchange
// and statistics, the two weight stages and two agg buffers; a tile's A
// operands and its y reuse its own buffer once out0 is read (the buffer
// is at least [TM][HC + 8] wide). Before the current item waits for its
// rows, the block issues the next item's into the other buffer (cp.async,
// 16 bytes, zeros past M), each thread's copies arriving on that buffer's
// mbarrier as they land (cp.async.mbarrier.arrive); the rows land during
// the current tile's LN0, off the critical path. (One bulk copy per row
// issued by one warp was tried first: the issuing warp held the block
// back, PERF.md.) Every item is computed alike whatever block takes it.
// In f32 at HC 256 K2 runs instead beside K3a (pma_epilogue_wg.cu), on
// its layout and warpgroup products: faster there in alternating pairs,
// slower in bf16 (PERF.md). At HC 384 and 512 K2 runs in both dtypes on a
// cluster of two blocks per 64-row tile, each block half the columns
// (pma_epilogue_cluster.cu), which halves the weight bytes a row.
//
// K3, the backward, recomputes the forward per tile (K2 stores nothing),
// then writes dagg = [dvals | dden | 0] in the activation dtype (at HC 256
// it runs on warpgroup products, pma_epilogue_wg.cu, and at 384 and 512 on
// a cluster of two blocks, pma_epilogue_cluster_bwd.cu; the K3 described
// here serves HC 64, 128 and 192). The
// parameter gradients are reduced without atomics, so they repeat bit for
// bit:
//   * K3a (persistent blocks over the row tiles): the row-local
//     backward; the small-vector grads (dseed, dg0, db0, dg1, db1, dbrff)
//     are column sums (each thread's 2 MT rows, then a fixed shuffle tree)
//     added into its warp group's [8, HC] table in shared memory by the
//     one lane that owns the column, the groups' tables then added in
//     order and written as the block's partial; the rFF layer inputs h_l
//     and output gradients dp_l are written out;
//   * K3b: dW partials [NCH, L, HC, HC] = h_l^T dp_l over 64 fixed row
//     chunks, 128x128 output tiles (64x64 at HC 64 and 192) per block of 8
//     warps on the tensor cores (3xTF32, or 2xTF32 where h is bf16), the
//     rows staged 32 at a time with cp.async, two stages;
//   * K3c: one more launch sums both partial tables over their first
//     axis in a fixed order (launch_reduce below).
// Runs (K2R/K3R): R statistical runs folded into the width. agg is
// [M, R*WP] with run r in columns [r*WP, (r+1)*WP), y [M, R*HC], the
// parameters carry a leading [R] axis, dW is [R, L, HC, HC] and dsmall
// [R, 8, HC]. The second grid axis of K3a runs over r (K3b folds r into
// its one axis, K2 into its items); a block offsets its pointers to its
// run and reads rows with the folded stride, so the body is K2/K3's and
// run r's outputs equal a single-run launch on run r's slice bit for bit
// (same tiles, same partials, same reduce order). R = 1 is the
// single-run layout.
// Shapes: HC in {64, 128, 192, 256, 384, 512}, H divides HC, WP >= HC + H,
// WP % 8 == 0, L in {1, 2}.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WG = 2;                   // warp groups, each a slice of 16 MT rows
constexpr int NWARPS = 8;               // warps per group, each HC / 8 columns
constexpr int THREADS = 32 * NWARPS * WG;
constexpr float EPS = 1e-5f;
constexpr float DEN_FLOOR = 1e-16f;

// The tile of a width (header note): MT 16-row mma tiles per warp, so TM
// = 16 MT WG rows per tile, and KS_F k rows per f32 weight slab (KS_B = 2
// KS_F k columns per bf16 slab, which then takes the same bytes); K3
// (bwd) and K2 size their slabs apart (K2 by its dtype's item size too).
// The tiled kernels take HC up to 256.
__host__ __device__ constexpr int mt_of(int) { return 2; }
__host__ __device__ constexpr int tm_of(int HC) { return 16 * mt_of(HC) * WG; }
__host__ __device__ constexpr int ksf_of(int HC, bool bwd, int item = 4) {
  return !bwd && item == 2 && HC % 128 == 0 ? 64 : 32;
}

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

// two consecutive values of a row, as f32, and their store
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// --- tensor-core products ---------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The lane's place in the mma layouts: warp group q, warp w in it,
// g = lane / 4, t = lane % 4. Element (m, j, e) of a warp's [16 MT, HC/8]
// register block is tile row 16 MT q + 16m + g + 8(e / 2), column
// w*HC/8 + 8j + 2t + e % 2.
template <int MT>
struct Lane {
  int q, w, g, t;
  __device__ Lane()
      : q(threadIdx.x / (32 * NWARPS)), w((threadIdx.x >> 5) % NWARPS),
        g((threadIdx.x >> 2) & 7), t(threadIdx.x & 3) {}
  __device__ int row(int m, int e) const { return 16 * (MT * q + m) + g + 8 * (e >> 1); }
};

// --- the weights, staged through shared memory ----------------------------

// one stage: [KS_F][HC + 8] f32, [HC][KS_F + 4] f32 or [HC][KS_B + 8] bf16
// (strides that make the fragment reads free of bank conflicts; the last
// two take the same bytes at KS_B = 2 KS_F)
__host__ __device__ constexpr size_t slab_bytes(int HC, int KS_F) {
  return (size_t)HC * (KS_F + 4) * 4 > (size_t)KS_F * (HC + 8) * 4
             ? (size_t)HC * (KS_F + 4) * 4
             : (size_t)KS_F * (HC + 8) * 4;
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
// the same, zero-filled where !valid (src is not read then)
__device__ __forceinline__ void cp16z(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two-stage pipeline over the HC / KS weight slabs of one product: every
// thread of the block copies its share of slab s + 1 (cp.async) while the
// warps multiply with slab s. load(buf, k0) issues the copies of the slab
// at k0; step(buf, k0) consumes it. Two barriers per slab. SB: the bytes
// of one stage.
template <int HC, int KS, size_t SB, typename Load, typename Step>
__device__ __forceinline__ void slab_pipeline(char* sB, Load load, Step step) {
  constexpr int NS = HC / KS;
  static_assert(HC % KS == 0, "a slab depth that divides HC");
  load(sB, 0);
  cp_commit();
#pragma unroll 1
  for (int s = 0; s < NS; ++s) {
    if (s + 1 < NS) {
      load(sB + ((s + 1) & 1) * SB, (s + 1) * KS);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    step(sB + (s & 1) * SB, s * KS);
    __syncthreads();  // slab s's buffer is refilled in the next iteration
  }
}

// acc += A @ B on the warp's columns [n0, n0 + 8 NT): A [TM, HC] bf16 in
// shared memory (row stride lda), B[k][n] = Bt[n * HC + k] bf16 in global
// memory, staged in slabs of KS_B = 2 KS_F; m16n8k16 with f32 accumulation.
template <int HC, int NT, int KS_F, int MT = mt_of(HC)>
__device__ __forceinline__ void gemm_bf16(const __nv_bfloat16* sA, int lda,
                                          const __nv_bfloat16* __restrict__ Bt, char* sB,
                                          int n0, const Lane<MT>& ln, float (&acc)[MT][NT][4]) {
  constexpr int KS_B = 2 * KS_F;
  constexpr int LDB = KS_B + 8;
  slab_pipeline<HC, KS_B, slab_bytes(HC, KS_F)>(
      sB,
      [&](char* buf, int k0) {
        __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(buf);
        for (int i = threadIdx.x; i < HC * (KS_B / 8); i += THREADS) {
          const int n = i / (KS_B / 8), c = i % (KS_B / 8);
          cp16(d + n * LDB + 8 * c, Bt + (size_t)n * HC + k0 + 8 * c);
        }
      },
      [&](const char* buf, int k0) {
        const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(buf);
#pragma unroll
        for (int kk = 0; kk < KS_B; kk += 16) {
          uint32_t bf[NT][2];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const __nv_bfloat16* p = b + (n0 + 8 * j + ln.g) * LDB + kk + 2 * ln.t;
            bf[j][0] = lds32(p);
            bf[j][1] = lds32(p + 8);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const __nv_bfloat16* p = sA + ln.row(m, 0) * lda + k0 + kk + 2 * ln.t;
            const uint32_t a[4] = {lds32(p), lds32(p + 8 * lda), lds32(p + 8),
                                   lds32(p + 8 * lda + 8)};
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_bf16(acc[m][j], a, bf[j]);
          }
        }
      });
}

// acc += A @ B at f32 accuracy (3xTF32) on the warp's columns: A [TM, HC]
// f32 in shared memory (row stride lda), B[k][n] = W[k * HC + n] (KMAJOR)
// or W[n * HC + k] f32 in global memory, staged in slabs of KS_F.
template <int HC, int NT, bool KMAJOR, int KS_F, int MT = mt_of(HC)>
__device__ __forceinline__ void gemm_f32(const float* sA, int lda, const float* __restrict__ W,
                                         char* sB, int n0, const Lane<MT>& ln,
                                         float (&acc)[MT][NT][4]) {
  constexpr int LDB = KMAJOR ? HC + 8 : KS_F + 4;
  slab_pipeline<HC, KS_F, slab_bytes(HC, KS_F)>(
      sB,
      [&](char* buf, int k0) {
        float* d = reinterpret_cast<float*>(buf);
        if (KMAJOR) {
          for (int i = threadIdx.x; i < KS_F * (HC / 4); i += THREADS) {
            const int k = i / (HC / 4), c = i % (HC / 4);
            cp16(d + k * LDB + 4 * c, W + (size_t)(k0 + k) * HC + 4 * c);
          }
        } else {
          for (int i = threadIdx.x; i < HC * (KS_F / 4); i += THREADS) {
            const int n = i / (KS_F / 4), c = i % (KS_F / 4);
            cp16(d + n * LDB + 4 * c, W + (size_t)n * HC + k0 + 4 * c);
          }
        }
      },
      [&](const char* buf, int k0) {
        const float* b = reinterpret_cast<const float*>(buf);
#pragma unroll
        for (int kk = 0; kk < KS_F; kk += 8) {
          uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int n = n0 + 8 * j + ln.g;
            const float* p = KMAJOR ? b + (kk + ln.t) * LDB + n : b + n * LDB + kk + ln.t;
            split_tf32(p[0], bh[j][0], bl[j][0]);
            split_tf32(KMAJOR ? p[4 * LDB] : p[4], bh[j][1], bl[j][1]);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float* p = sA + ln.row(m, 0) * lda + k0 + kk + ln.t;
            const float a[4] = {p[0], p[8 * lda], p[4], p[8 * lda + 4]};
            uint32_t ah[4], al[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              mma_tf32(acc[m][j], al, bh[j]);
              mma_tf32(acc[m][j], ah, bl[j]);
              mma_tf32(acc[m][j], ah, bh[j]);
            }
          }
        }
      });
}

// --- the row tile -------------------------------------------------------------

// Pointers offset to one run; lda, ldg: the folded row strides of agg
// (and dagg) and of y (and gy).
template <typename T>
struct Args {
  const T* agg;
  const T* gy;
  const float *seed, *g0, *b0, *brff, *g1, *b1;
  const float* Wf;                 // [L, HC, HC] f32, [in][out]
  const __nv_bfloat16* Wbt;        // [L, HC, HC] bf16, [out][in] (bf16 path)
  T* out;                          // K2: y; K3: dagg
  T* hin;                          // K3: [L, M, HC] rFF inputs
  float* dpbuf;                    // K3: [L, M, HC] rFF output gradients
  float* part_small;               // K3: [gridDim.x, 8, HC]
  int M, H, L, WP, relu;
  size_t lda, ldg;
};

template <int HC, bool DG>
__host__ __device__ constexpr int agg_width(int H) {
  return DG ? HC + 8 : (HC + H + 7) / 8 * 8;
}

// Copy the first W columns of the staged tile of TM rows (row stride SW)
// to rows of dst (row stride ld), 16 bytes at a time; rows past M are not
// written.
template <typename T>
__device__ __forceinline__ void store_tile(const Args<T>& A, int row0, int TM, const T* sT,
                                           int SW, int W, T* dst, size_t ld) {
  constexpr int V = 16 / sizeof(T);
  const int nv = W / V;
  for (int i = threadIdx.x; i < TM * nv; i += THREADS) {
    const int r = i / nv, c = i % nv, grow = row0 + r;
    if (grow >= A.M) continue;
    *reinterpret_cast<uint4*>(dst + (size_t)grow * ld + c * V) =
        *reinterpret_cast<const uint4*>(sT + r * SW + c * V);
  }
}

// the denominator of tile row r, head h: staged, or with DG from global
// memory (0 past M either way)
template <typename T, int HC, bool DG>
__device__ __forceinline__ float den_at(const Args<T>& A, const T* sAgg, int row0, int r,
                                        int h) {
  if (!DG) return to_f(sAgg[r * agg_width<HC, DG>(A.H) + HC + h]);
  const int grow = row0 + r;
  return grow < A.M ? to_f(__ldg(A.agg + (size_t)grow * A.lda + HC + h)) : 0.f;
}

// out0 = vals / max(den, floor) + seed of tile element (r, c), from the
// staged agg rows (zeros past M)
template <typename T, int HC, bool DG>
__device__ __forceinline__ float out0_at(const Args<T>& A, const T* sAgg, int row0, int r,
                                         int c, float& v, float& dinv) {
  v = to_f(sAgg[r * agg_width<HC, DG>(A.H) + c]);
  const float den = den_at<T, HC, DG>(A, sAgg, row0, r, c / (HC / A.H));
  dinv = __frcp_rn(fmaxf(den, DEN_FLOOR));
  return __fadd_rn(__fmul_rn(v, dinv), A.seed[c]);
}

// Row totals over all HC columns of two per-element quantities: pa[i],
// pb[i] hold the thread's partial sums for row Lane::row(i / 2, 2 (i % 2));
// on return, the totals (fixed order: t lanes by a shuffle tree, then the
// group's warps in order). Two barriers.
template <int MT>
__device__ __forceinline__ void row_reduce(float (&pa)[2 * MT], float (&pb)[2 * MT],
                                           float* red, const Lane<MT>& ln) {
  constexpr int TM = 16 * MT * WG;
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) {
    pa[i] += __shfl_xor_sync(0xffffffffu, pa[i], 1);
    pa[i] += __shfl_xor_sync(0xffffffffu, pa[i], 2);
    pb[i] += __shfl_xor_sync(0xffffffffu, pb[i], 1);
    pb[i] += __shfl_xor_sync(0xffffffffu, pb[i], 2);
  }
  if (ln.t == 0) {
#pragma unroll
    for (int i = 0; i < 2 * MT; ++i) {
      const int r = ln.row(i >> 1, 2 * (i & 1));
      red[ln.w * TM + r] = pa[i];
      red[(NWARPS + ln.w) * TM + r] = pb[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) {
    const int r = ln.row(i >> 1, 2 * (i & 1));
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      a += red[w * TM + r];
      b += red[(NWARPS + w) * TM + r];
    }
    pa[i] = a;
    pb[i] = b;
  }
  __syncthreads();
}

// dst[c] += sum over the warp's rows of f(m, j, e) for each of its
// columns c: the thread's 2 MT rows in order, then a shuffle tree over g;
// the lane with g == 0 owns column c in its warp group's table dst, so no
// two lanes write one address.
template <int MT, int NT, typename F>
__device__ __forceinline__ void col_add(F f, float* dst, int n0, const Lane<MT>& ln) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m) s += f(m, j, q) + f(m, j, q + 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (ln.g == 0) dst[n0 + 8 * j + 2 * ln.t + q] += s;
    }
}

// The A operand [TM][HC] of the next product from the register blocks:
// T values ([TM][HC + 8]) or f32 ([TM][HC + 4]).
template <typename T, int HC, int NT, int MT = mt_of(HC)>
__device__ __forceinline__ void put_a(const float (&x)[MT][NT][4], char* smem, int n0,
                                      const Lane<MT>& ln) {
  constexpr int LD = sizeof(T) == 4 ? HC + 4 : HC + 8;
  T* s = reinterpret_cast<T*>(smem);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2(s + ln.row(m, 2 * h) * LD + n0 + 8 * j + 2 * ln.t, x[m][j][2 * h],
               x[m][j][2 * h + 1]);
}

// acc = A (in shared memory, dtype T) @ W_l, W_l given as f32 [in][out]
// and, on the bf16 path, as bf16 [out][in]; weight slabs of KS_F
template <typename T, int HC, int NT, int KS_F, int MT = mt_of(HC)>
__device__ __forceinline__ void rff_product(const Args<T>& A, int l, const char* smem, char* sB,
                                            int n0, const Lane<MT>& ln,
                                            float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  if constexpr (sizeof(T) == 4)
    gemm_f32<HC, NT, true, KS_F>(reinterpret_cast<const float*>(smem), HC + 4,
                                 A.Wf + (size_t)l * HC * HC, sB, n0, ln, acc);
  else
    gemm_bf16<HC, NT, KS_F>(reinterpret_cast<const __nv_bfloat16*>(smem), HC + 8,
                            A.Wbt + (size_t)l * HC * HC, sB, n0, ln, acc);
}

// Forward chain of the tile at row0 (pallas_pma.py::_fwd_recompute) from
// its staged agg rows sAgg; the A operands go to sA (which may be sAgg:
// out0 is read before the first of them is written), the row statistics
// through red and stat, the weight slabs of KS_F through sB. On return X
// = xhat1, stat = [mu0, rstd0, rstd1] per row, and the bits
// (m*NT + j)*4 + e of pos0 / posL say p_0 > 0 / p_{L-1} > 0. In K3 (BWD)
// the rFF inputs are written to A.hin.
template <typename T, int HC, bool BWD, bool DG, int KS_F, int MT = mt_of(HC)>
__device__ __forceinline__ void fwd_chain(const Args<T>& A, int row0, const T* sAgg, char* sA,
                                          float* red, float* stat, char* sB,
                                          float (&X)[MT][HC / 64][4],
                                          float (&P)[MT][HC / 64][4], uint64_t& pos0,
                                          uint64_t& posL) {
  constexpr int NT = HC / 64, TM = 16 * MT * WG;
  const Lane<MT> ln;
  const int n0 = ln.w * (HC / 8);
  float pa[2 * MT], pb[2 * MT];
  // 1. out0 and LN0 -> zb (kept in X)
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) pa[i] = pb[i] = 0.f;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v, dinv;
        const float x = out0_at<T, HC, DG>(A, sAgg, row0, ln.row(m, e),
                                           n0 + 8 * j + 2 * ln.t + (e & 1), v, dinv);
        X[m][j][e] = x;
        pa[2 * m + (e >> 1)] += x;
        pb[2 * m + (e >> 1)] += x * x;
      }
  row_reduce(pa, pb, red, ln);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * m + h, r = ln.row(m, 2 * h);
      const float mu = pa[i] / HC;
      const float rstd = rsqrtf(pb[i] / HC - mu * mu + EPS);
      if (ln.w == 0 && ln.t == 0) stat[r] = mu, stat[TM + r] = rstd;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = n0 + 8 * j + 2 * ln.t + q;
          const float xh = __fmul_rn(__fsub_rn(X[m][j][2 * h + q], mu), rstd);
          X[m][j][2 * h + q] = round_to<T>(__fadd_rn(__fmul_rn(xh, A.g0[c]), A.b0[c]));
        }
    }
  if (BWD) {  // h_0 = zb
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int grow = row0 + ln.row(m, 2 * h);
        if (grow >= A.M) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          store2(A.hin + (size_t)grow * HC + n0 + 8 * j + 2 * ln.t, X[m][j][2 * h],
                 X[m][j][2 * h + 1]);
      }
  }
  put_a<T, HC, NT>(X, sA, n0, ln);
  __syncthreads();
  // 2. rFF with TorchDense rounding; p_l in P
  for (int l = 0; l < A.L; ++l) {
    rff_product<T, HC, NT, KS_F>(A, l, sA, sB, n0, ln, P);
    uint64_t pos = 0;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n0 + 8 * j + 2 * ln.t + (e & 1);
          const float p = round_to<T>(__fadd_rn(round_to<T>(P[m][j][e]), A.brff[l * HC + c]));
          P[m][j][e] = p;
          if (p > 0.f) pos |= 1ull << ((m * NT + j) * 4 + e);
        }
    if (l == 0) pos0 = pos;
    posL = pos;
    if (l + 1 < A.L) {  // h_1 = relu(p_0), exact in T (p_0 lives on as pos0)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) P[m][j][e] = fmaxf(P[m][j][e], 0.f);
      if (BWD) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int grow = row0 + ln.row(m, 2 * h);
            if (grow >= A.M) continue;
#pragma unroll
            for (int j = 0; j < NT; ++j)
              store2(A.hin + ((size_t)(l + 1) * A.M + grow) * HC + n0 + 8 * j + 2 * ln.t,
                     P[m][j][2 * h], P[m][j][2 * h + 1]);
          }
      }
      __syncthreads();  // every warp is done reading zb
      put_a<T, HC, NT>(P, sA, n0, ln);
      __syncthreads();
    }
  }
  // 3. out2 = zb + relu(p_L-1), LN1 -> xhat1 in X
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) pa[i] = pb[i] = 0.f;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float o = __fadd_rn(X[m][j][e], fmaxf(P[m][j][e], 0.f));
        X[m][j][e] = o;
        pa[2 * m + (e >> 1)] += o;
        pb[2 * m + (e >> 1)] += o * o;
      }
  row_reduce(pa, pb, red, ln);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * m + h;
      const float mu = pa[i] / HC;
      const float rstd = rsqrtf(pb[i] / HC - mu * mu + EPS);
      if (ln.w == 0 && ln.t == 0) stat[2 * TM + ln.row(m, 2 * h)] = rstd;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          X[m][j][2 * h + q] = __fmul_rn(__fsub_rn(X[m][j][2 * h + q], mu), rstd);
    }
}

// K3c: both partial tables of K3 reduced in one launch (run = blockIdx.y):
//   dW[run][j] = sum_p part_w[run][p][j], added in the order of p: one
//                float4 column a thread, RED_PB partials' loads in flight
//                before they are added;
//   ds[run][j] = sum_p part_s[run][p][j] over the row blocks' partials:
//                RED_SL fixed slices of p (p = sl, sl + RED_SL, ...) added
//                in order by RED_SL threads, then the slices in order.
// Blocks [0, wblocks) take dW's float4 columns, the rest RED_SC float4
// columns of ds each. Reading both tables once bounds it (bytes); the
// order of every sum is fixed, so K3R's run r is K3's bit for bit.
constexpr int RED_THREADS = 128;
constexpr int RED_PB = 16;                       // dW partials in flight a thread
constexpr int RED_SL = 8;                        // ds: slices of p
constexpr int RED_SC = RED_THREADS / RED_SL;     // ds: float4 columns a block

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
}

__global__ void __launch_bounds__(RED_THREADS) reduce_partials_kernel(
    const float* __restrict__ part_w, int nch, int nw, float* __restrict__ dW,
    const float* __restrict__ part_s, int nsp, int ns, float* __restrict__ ds, int wblocks) {
  const int run = blockIdx.y;
  if ((int)blockIdx.x < wblocks) {
    const int nw4 = nw / 4, j = blockIdx.x * RED_THREADS + threadIdx.x;
    if (j >= nw4) return;
    const float4* src = reinterpret_cast<const float4*>(part_w) + (size_t)run * nch * nw4 + j;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int p = 0;
    for (; p + RED_PB <= nch; p += RED_PB) {
      float4 x[RED_PB];
#pragma unroll
      for (int u = 0; u < RED_PB; ++u) x[u] = __ldg(src + (size_t)(p + u) * nw4);
#pragma unroll
      for (int u = 0; u < RED_PB; ++u) add4(acc, x[u]);
    }
    for (; p < nch; ++p) add4(acc, __ldg(src + (size_t)p * nw4));
    reinterpret_cast<float4*>(dW)[(size_t)run * nw4 + j] = acc;
    return;
  }
  __shared__ float4 sl_sum[RED_SL][RED_SC];
  const int ns4 = ns / 4, c = threadIdx.x % RED_SC, sl = threadIdx.x / RED_SC;
  const int j = (blockIdx.x - wblocks) * RED_SC + c;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j < ns4) {
    const float4* src = reinterpret_cast<const float4*>(part_s) + (size_t)run * nsp * ns4 + j;
#pragma unroll 4
    for (int p = sl; p < nsp; p += RED_SL) add4(acc, __ldg(src + (size_t)p * ns4));
  }
  sl_sum[sl][c] = acc;
  __syncthreads();
  if (sl != 0 || j >= ns4) return;
#pragma unroll
  for (int k = 1; k < RED_SL; ++k) add4(acc, sl_sum[k][c]);
  reinterpret_cast<float4*>(ds)[(size_t)run * ns4 + j] = acc;
}

// K3c's launch: dW [R][nw] from part_w [R][nch][nw], ds [R][ns] from
// part_s [R][nsp][ns] (nw, ns multiples of 4)
inline cudaError_t launch_reduce(const float* part_w, int nch, int nw, float* dW,
                                 const float* part_s, int nsp, int ns, float* ds, int R,
                                 cudaStream_t s) {
  const int wblocks = (nw / 4 + RED_THREADS - 1) / RED_THREADS;
  const int sblocks = (ns / 4 + RED_SC - 1) / RED_SC;
  reduce_partials_kernel<<<dim3(wblocks + sblocks, R), RED_THREADS, 0, s>>>(
      part_w, nch, nw, dW, part_s, nsp, ns, ds, wblocks);
  return cudaGetLastError();
}

// run `run`'s parameters and rows
template <typename T>
__device__ __forceinline__ Args<T> at_run(Args<T> A, int HC, int run) {
  A.agg += (size_t)run * A.WP;
  A.out += (size_t)run * (A.gy ? A.WP : HC);  // dagg in K3, y in K2
  if (A.gy) A.gy += (size_t)run * HC;
  A.seed += (size_t)run * HC, A.g0 += (size_t)run * HC, A.b0 += (size_t)run * HC;
  A.g1 += (size_t)run * HC, A.b1 += (size_t)run * HC;
  A.Wf += (size_t)run * A.L * HC * HC;
  if (A.Wbt) A.Wbt += (size_t)run * A.L * HC * HC;
  A.brff += (size_t)run * A.L * HC;
  if (A.hin) {
    A.hin += (size_t)run * A.L * A.M * HC;
    A.dpbuf += (size_t)run * A.L * A.M * HC;
    A.part_small += (size_t)run * gridDim.x * 8 * HC;
  }
  return A;
}

// The opt-in shared memory of a block on the H100. The denominators are
// staged unless that would overflow it; at H = HC (the widest stage) that
// happens for f32 at HC >= 256 in K3 and at HC >= 192 in K2, and for bf16
// nowhere, so only there is DG instantiated.
constexpr size_t SMEM_MAX = 227 * 1024;

template <typename T>
Args<T> make_args(const void* agg, const void* gy, const void* seed, const void* g0,
                  const void* b0, const void* Wf, const void* Wbt, const void* brff,
                  const void* g1, const void* b1, void* out, void* hin, void* dpbuf,
                  void* part_small, int M, int WP, int HC, int H, int L, int R, int relu) {
  Args<T> A;
  A.agg = static_cast<const T*>(agg);
  A.gy = static_cast<const T*>(gy);
  A.seed = static_cast<const float*>(seed);
  A.g0 = static_cast<const float*>(g0);
  A.b0 = static_cast<const float*>(b0);
  A.brff = static_cast<const float*>(brff);
  A.g1 = static_cast<const float*>(g1);
  A.b1 = static_cast<const float*>(b1);
  A.Wf = static_cast<const float*>(Wf);
  A.Wbt = static_cast<const __nv_bfloat16*>(Wbt);
  A.out = static_cast<T*>(out);
  A.hin = static_cast<T*>(hin);
  A.dpbuf = static_cast<float*>(dpbuf);
  A.part_small = static_cast<float*>(part_small);
  A.M = M, A.H = H, A.L = L, A.WP = WP, A.relu = relu;
  A.lda = (size_t)R * WP;
  A.ldg = (size_t)R * HC;
  return A;
}

}  // namespace
