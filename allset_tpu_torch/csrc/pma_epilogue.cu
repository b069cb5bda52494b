// K2 / K3: the fused PMA epilogue, forward and backward.
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
//   * a tile of 64 rows per block iteration, 16 warps in two groups of 8;
//     group q owns rows [32q, 32q + 32), warp w of a group the columns
//     [w*HC/8, (w+1)*HC/8), and each warp keeps its [32, HC/8] share of
//     every intermediate in registers in the mma accumulator layout (two
//     16-row m-tiles: with four, 8 warps needed 255 registers and
//     spilled). Row statistics (LN means, the LN backward's row sums) are
//     per-warp partial sums exchanged through shared memory in a fixed
//     order. The tile's agg rows are staged in shared memory once
//     (cp.async, 16 bytes), read there by the three passes that need
//     out0, and y (K2) or dagg (K3) leave through the same buffer in
//     16-byte rows. Where the H denominators would overflow shared memory
//     (f32 at HC = 256 with 32 heads or more in K3, 128 or more in K2),
//     a second instantiation (DG) stages only the values and reads den
//     from global memory, writing dden straight out; the A operand of the
//     next product ([64, HC], 66.5 KB at HC = 256 f32) lives in shared
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
//   * the weights pass through shared memory in slabs (32 k-rows in f32,
//     64 k-columns in bf16; 37 KB at HC = 256), two stages: the whole block
//     copies slab s + 1 with cp.async while its warps multiply with slab
//     s. At HC = 256 a layer's weights (128 KB in bf16, 256 KB in f32) do
//     not fit beside the tile, so they stream from L2 once per 64-row
//     tile (4 KB per row and product at f32);
//   * the rounding points of _fwd_recompute are kept; the additions that
//     feed a rounding (out0, LN) use explicit _rn intrinsics, so the
//     forward and the backward's recompute round alike.
//
// K3, the backward, recomputes the forward per tile (K2 stores nothing),
// then writes dagg = [dvals | dden | 0] in the activation dtype. The
// parameter gradients are reduced without atomics, so they repeat bit for
// bit:
//   * K3a (persistent blocks over the 64-row tiles): the row-local
//     backward; the small-vector grads (dseed, dg0, db0, dg1, db1, dbrff)
//     are column sums (each thread's 4 rows, then a fixed shuffle tree)
//     added into its warp group's [8, HC] table in shared memory by the
//     one lane that owns the column, the groups' tables then added in
//     order and written as the block's partial; the rFF layer inputs h_l
//     and output gradients dp_l are written out;
//   * K3b: dW partials [NCH, L, HC, HC] = h_l^T dp_l over 64 fixed row
//     chunks, 128x128 output tiles (64x64 at HC = 64) per block of 8
//     warps on the tensor cores (3xTF32, or 2xTF32 where h is bf16), the
//     rows staged 32 at a time with cp.async, two stages;
//   * K3c: a second kernel sums each partial table over its first axis
//     in a fixed order.
// Runs (K2R/K3R): R statistical runs folded into the width. agg is
// [M, R*WP] with run r in columns [r*WP, (r+1)*WP), y [M, R*HC], the
// parameters carry a leading [R] axis, dW is [R, L, HC, HC] and dsmall
// [R, 8, HC]. The second grid axis of K2 and K3a runs over r (K3b folds r
// into its one axis); a block offsets its pointers to its run and reads
// rows with the folded stride, so the body is K2/K3's and run r's outputs
// equal a single-run launch on run r's slice bit for bit (same tiles,
// same partials, same reduce order). R = 1 is the single-run layout.
// Shapes: HC in {64, 128, 192, 256}, H divides HC, WP >= HC + H, L in
// {1, 2}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MT = 2;                   // 16-row mma tiles per warp
constexpr int WG = 2;                   // warp groups, each a slice of 16 MT rows
constexpr int TM = 16 * MT * WG;        // rows per tile
constexpr int NWARPS = 8;               // warps per group, each HC / 8 columns
constexpr int THREADS = 32 * NWARPS * WG;
constexpr float EPS = 1e-5f;
constexpr float DEN_FLOOR = 1e-16f;

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
struct Lane {
  int q, w, g, t;
  __device__ Lane()
      : q(threadIdx.x / (32 * NWARPS)), w((threadIdx.x >> 5) % NWARPS),
        g((threadIdx.x >> 2) & 7), t(threadIdx.x & 3) {}
  __device__ int row(int m, int e) const { return 16 * (MT * q + m) + g + 8 * (e >> 1); }
};

// --- the weights, staged through shared memory ----------------------------

constexpr int KS_F = 32;  // k rows of an f32 weight slab
constexpr int KS_B = 64;  // k columns of a bf16 weight slab

// one stage: [KS_F][HC + 8] f32, [HC][KS_F + 4] f32 or [HC][KS_B + 8] bf16
// (strides that make the fragment reads free of bank conflicts)
__host__ __device__ constexpr size_t slab_bytes(int HC) {
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
// at k0; step(buf, k0) consumes it. Two barriers per slab.
template <int HC, int KS, typename Load, typename Step>
__device__ __forceinline__ void slab_pipeline(char* sB, Load load, Step step) {
  constexpr int NS = HC / KS;
  constexpr size_t SB = slab_bytes(HC);
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
// memory, staged in slabs of KS_B; m16n8k16 with f32 accumulation.
template <int HC, int NT>
__device__ __forceinline__ void gemm_bf16(const __nv_bfloat16* sA, int lda,
                                          const __nv_bfloat16* __restrict__ Bt, char* sB,
                                          int n0, const Lane& ln, float (&acc)[MT][NT][4]) {
  constexpr int LDB = KS_B + 8;
  slab_pipeline<HC, KS_B>(
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
template <int HC, int NT, bool KMAJOR>
__device__ __forceinline__ void gemm_f32(const float* sA, int lda, const float* __restrict__ W,
                                         char* sB, int n0, const Lane& ln,
                                         float (&acc)[MT][NT][4]) {
  constexpr int LDB = KMAJOR ? HC + 8 : KS_F + 4;
  slab_pipeline<HC, KS_F>(
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

// shared memory: the A operand [TM][HC + 4] f32 (or [TM][HC + 8] T), the
// row-sum exchange [2][NWARPS][TM], the row statistics mu0, rstd0, rstd1
// [3][TM], in K3 each warp group's column sums [WG][8][HC], the two weight
// stages, and the tile's rows of agg [TM][SW] in T: SW = HC + H rounded up
// to 8 columns, or, with den in global memory (DG), the values alone in SW
// = HC + 8 (in K2 the tile's y on the way out, in K3 its dagg)
__host__ __device__ constexpr size_t stage_offset(int HC, bool bwd) {
  return (size_t)TM * (HC + 4) * 4 + 2 * NWARPS * TM * 4 + 3 * TM * 4 +
         (bwd ? (size_t)WG * 8 * HC * 4 : 0);
}
__host__ __device__ constexpr size_t agg_offset(int HC, bool bwd) {
  return stage_offset(HC, bwd) + 2 * slab_bytes(HC);
}
template <int HC, bool DG>
__host__ __device__ constexpr int agg_width(int H) {
  return DG ? HC + 8 : (HC + H + 7) / 8 * 8;
}
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int HC, bool bwd, int SW) {
  return agg_offset(HC, bwd) + (size_t)TM * SW * sizeof(T);
}

// Stage rows [row0, row0 + TM) of agg, their first SW columns (HC with
// DG), zeros past M: 16-byte copies by the whole block, one wait, one
// barrier.
template <typename T, int HC, bool DG>
__device__ __forceinline__ void load_agg(const Args<T>& A, int row0, T* sAgg) {
  constexpr int V = 16 / sizeof(T);
  const int SW = agg_width<HC, DG>(A.H), nv = (DG ? HC : SW) / V;
  for (int i = threadIdx.x; i < TM * nv; i += THREADS) {
    const int r = i / nv, c = i % nv, grow = row0 + r;
    cp16z(sAgg + r * SW + c * V, A.agg + (size_t)(grow < A.M ? grow : 0) * A.lda + c * V,
          grow < A.M);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();
}

// Copy the first W columns of the staged tile (row stride SW) to rows of
// dst (row stride ld), 16 bytes at a time; rows past M are not written.
template <typename T>
__device__ __forceinline__ void store_tile(const Args<T>& A, int row0, const T* sT, int SW,
                                           int W, T* dst, size_t ld) {
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
__device__ __forceinline__ void row_reduce(float (&pa)[2 * MT], float (&pb)[2 * MT],
                                           float* red, const Lane& ln) {
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
template <int NT, typename F>
__device__ __forceinline__ void col_add(F f, float* dst, int n0, const Lane& ln) {
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
template <typename T, int HC, int NT>
__device__ __forceinline__ void put_a(const float (&x)[MT][NT][4], char* smem, int n0,
                                      const Lane& ln) {
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
// and, on the bf16 path, as bf16 [out][in]
template <typename T, int HC, int NT>
__device__ __forceinline__ void rff_product(const Args<T>& A, int l, const char* smem, char* sB,
                                            int n0, const Lane& ln, float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  if constexpr (sizeof(T) == 4)
    gemm_f32<HC, NT, true>(reinterpret_cast<const float*>(smem), HC + 4,
                           A.Wf + (size_t)l * HC * HC, sB, n0, ln, acc);
  else
    gemm_bf16<HC, NT>(reinterpret_cast<const __nv_bfloat16*>(smem), HC + 8,
                      A.Wbt + (size_t)l * HC * HC, sB, n0, ln, acc);
}

// Forward chain of the tile at row0 (pallas_pma.py::_fwd_recompute). On
// return X = xhat1, stat = [mu0, rstd0, rstd1] per row, and the bits
// (m*NT + j)*4 + e of pos0 / posL say p_0 > 0 / p_{L-1} > 0. In K3 (BWD)
// the rFF inputs are written to A.hin.
template <typename T, int HC, bool BWD, bool DG>
__device__ __forceinline__ void fwd_tile(const Args<T>& A, int row0, char* smem,
                                         float (&X)[MT][HC / 64][4], float (&P)[MT][HC / 64][4],
                                         uint64_t& pos0, uint64_t& posL) {
  constexpr int NT = HC / 64;
  const Lane ln;
  const int n0 = ln.w * (HC / 8);
  float* red = reinterpret_cast<float*>(smem + (size_t)TM * (HC + 4) * 4);
  float* stat = red + 2 * NWARPS * TM;
  char* sB = smem + stage_offset(HC, BWD);
  T* sAgg = reinterpret_cast<T*>(smem + agg_offset(HC, BWD));
  float pa[2 * MT], pb[2 * MT];
  load_agg<T, HC, DG>(A, row0, sAgg);
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
  put_a<T, HC, NT>(X, smem, n0, ln);
  __syncthreads();
  // 2. rFF with TorchDense rounding; p_l in P
  for (int l = 0; l < A.L; ++l) {
    rff_product<T, HC, NT>(A, l, smem, sB, n0, ln, P);
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
      put_a<T, HC, NT>(P, smem, n0, ln);
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

// the run's parameters and rows (blockIdx.y = run of R = gridDim.y)
template <typename T>
__device__ __forceinline__ Args<T> at_run(Args<T> A, int HC) {
  const int run = blockIdx.y;
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

template <typename T, int HC, bool DG>
__global__ void __launch_bounds__(THREADS, 1) pma_fwd_kernel(Args<T> A0) {
  constexpr int NT = HC / 64;
  extern __shared__ __align__(128) char smem[];
  const Args<T> A = at_run(A0, HC);
  const Lane ln;
  const int n0 = ln.w * (HC / 8), row0 = blockIdx.x * TM;
  float X[MT][NT][4], P[MT][NT][4];
  uint64_t pos0, posL;
  fwd_tile<T, HC, false, DG>(A, row0, smem, X, P, pos0, posL);
  // y through the agg stage (read only before the products), then out
  T* sY = reinterpret_cast<T*>(smem + agg_offset(HC, false));
  const int SW = agg_width<HC, DG>(A.H);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ln.row(m, 2 * h);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = n0 + 8 * j + 2 * ln.t;
        float y[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          y[q] = round_to<T>(__fadd_rn(__fmul_rn(X[m][j][2 * h + q], A.g1[c + q]), A.b1[c + q]));
          if (A.relu && !(y[q] > 0.f)) y[q] = 0.f;
        }
        store2(sY + r * SW + c, y[0], y[1]);
      }
    }
  __syncthreads();
  store_tile(A, row0, sY, SW, HC, A.out, A.ldg);
}

// K3a: row-local backward of one tile per iteration (pallas_pma.py:204-256).
template <typename T, int HC, bool DG>
__global__ void __launch_bounds__(THREADS, 1) pma_bwd_rows_kernel(Args<T> A0) {
  constexpr int NT = HC / 64;
  extern __shared__ __align__(128) char smem[];
  const Args<T> A = at_run(A0, HC);
  const Lane ln;
  const int n0 = ln.w * (HC / 8), C = HC / A.H, SW = agg_width<HC, DG>(A.H);
  const int W = DG ? HC : SW;  // the staged columns of dagg
  float* sf = reinterpret_cast<float*>(smem);  // the A operand as f32 [TM][HC + 4]
  T* sAgg = reinterpret_cast<T*>(smem + agg_offset(HC, true));  // the tile's agg, then dagg
  float* red = sf + TM * (HC + 4);
  float* stat = red + 2 * NWARPS * TM;
  // per warp group: dseed, dg0, db0, dg1, db1, dbrff[0..2]
  float* csum0 = stat + 3 * TM;
  float* csum = csum0 + ln.q * 8 * HC;
  for (int i = threadIdx.x; i < WG * 8 * HC; i += THREADS) csum0[i] = 0.f;
  __syncthreads();
  float X[MT][NT][4], P[MT][NT][4];
  float pa[2 * MT], pb[2 * MT];
  const int ntiles = (A.M + TM - 1) / TM;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * TM;
    uint64_t pos0, posL;
    fwd_tile<T, HC, true, DG>(A, row0, smem, X, P, pos0, posL);
    // 4. upstream gradient (the folded relu masks on the ROUNDED output)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int grow = row0 + ln.row(m, 2 * h);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = n0 + 8 * j + 2 * ln.t;
          const float2 gv = grow < A.M ? load2(A.gy + (size_t)grow * A.ldg + c)
                                       : make_float2(0.f, 0.f);
          P[m][j][2 * h] = gv.x;
          P[m][j][2 * h + 1] = gv.y;
          if (A.relu) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float y = round_to<T>(
                  __fadd_rn(__fmul_rn(X[m][j][2 * h + q], A.g1[c + q]), A.b1[c + q]));
              if (!(y > 0.f)) P[m][j][2 * h + q] = 0.f;
            }
          }
        }
      }
    col_add<NT>([&](int m, int j, int e) { return P[m][j][e] * X[m][j][e]; }, csum + 3 * HC,
                n0, ln);  // dg1
    col_add<NT>([&](int m, int j, int e) { return P[m][j][e]; }, csum + 4 * HC, n0, ln);
    // LN1 backward: P <- dz = dout2; X <- dp = dout2 * (p_L-1 > 0)
#pragma unroll
    for (int i = 0; i < 2 * MT; ++i) pa[i] = pb[i] = 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float gg = P[m][j][e] * A.g1[n0 + 8 * j + 2 * ln.t + (e & 1)];
          pa[2 * m + (e >> 1)] += gg;
          pb[2 * m + (e >> 1)] += gg * X[m][j][e];
        }
    row_reduce(pa, pb, red, ln);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 2 * m + (e >> 1);
          const float rstd = stat[2 * TM + ln.row(m, e)];
          const float gg = P[m][j][e] * A.g1[n0 + 8 * j + 2 * ln.t + (e & 1)];
          const float d = rstd * (gg - pa[i] / HC - X[m][j][e] * (pb[i] / HC));
          P[m][j][e] = d;
          X[m][j][e] = (posL >> ((m * NT + j) * 4 + e)) & 1 ? d : 0.f;
        }
    // 5. rFF backward, last layer first: X = dp_l
    for (int l = A.L - 1; l >= 0; --l) {
      col_add<NT>([&](int m, int j, int e) { return X[m][j][e]; }, csum + (5 + l) * HC, n0, ln);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int grow = row0 + ln.row(m, 2 * h);
          if (grow >= A.M) continue;
#pragma unroll
          for (int j = 0; j < NT; ++j)
            store2(A.dpbuf + ((size_t)l * A.M + grow) * HC + n0 + 8 * j + 2 * ln.t,
                   X[m][j][2 * h], X[m][j][2 * h + 1]);
        }
      __syncthreads();  // every warp is done with the previous A operand
      put_a<float, HC, NT>(X, smem, n0, ln);
      __syncthreads();
      // dh = dp_l @ W_l^T: B[k][n] = W_l[n][k]
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) X[m][j][e] = 0.f;
      gemm_f32<HC, NT, false>(sf, HC + 4, A.Wf + (size_t)l * HC * HC,
                              smem + stage_offset(HC, true), n0, ln, X);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (l > 0) {
              if (!((pos0 >> ((m * NT + j) * 4 + e)) & 1)) X[m][j][e] = 0.f;
            } else {
              P[m][j][e] += X[m][j][e];
            }
          }
    }
    // 6. LN0 backward (xhat0 recomputed into X) -> dout0 in P
#pragma unroll
    for (int i = 0; i < 2 * MT; ++i) pa[i] = pb[i] = 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = ln.row(m, e), c = n0 + 8 * j + 2 * ln.t + (e & 1);
          float v, dinv;
          const float x = out0_at<T, HC, DG>(A, sAgg, row0, r, c, v, dinv);
          const float xh = __fmul_rn(__fsub_rn(x, stat[r]), stat[TM + r]);
          X[m][j][e] = xh;
          const float gg = P[m][j][e] * A.g0[c];
          pa[2 * m + (e >> 1)] += gg;
          pb[2 * m + (e >> 1)] += gg * xh;
        }
    col_add<NT>([&](int m, int j, int e) { return P[m][j][e] * X[m][j][e]; }, csum + HC, n0,
                ln);  // dg0
    col_add<NT>([&](int m, int j, int e) { return P[m][j][e]; }, csum + 2 * HC, n0, ln);
    row_reduce(pa, pb, red, ln);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 2 * m + (e >> 1), r = ln.row(m, e);
          const float gg = P[m][j][e] * A.g0[n0 + 8 * j + 2 * ln.t + (e & 1)];
          P[m][j][e] = stat[TM + r] * (gg - pa[i] / HC - X[m][j][e] * (pb[i] / HC));
        }
    col_add<NT>([&](int m, int j, int e) { return P[m][j][e]; }, csum, n0, ln);  // dseed
    // dvals over the staged vals; dout0 * vals -> the A buffer for the
    // per-head dden sums; then dden over den and zeros in the pad columns,
    // into the stage (or, past its W columns, straight out), and the
    // tile's dagg rows out, 16 bytes at a time
    __syncthreads();  // every warp is done with the last product's A operand
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ln.row(m, 2 * h);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = n0 + 8 * j + 2 * ln.t;
          float d[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float v, dinv;
            out0_at<T, HC, DG>(A, sAgg, row0, r, c + q, v, dinv);
            const float d0 = P[m][j][2 * h + q];
            d[q] = d0 * dinv;
            sf[r * (HC + 4) + c + q] = d0 * v;
          }
          store2(sAgg + r * SW + c, d[0], d[1]);
        }
      }
    __syncthreads();
    const int NP = A.WP - HC;
    for (int i = threadIdx.x; i < TM * NP; i += THREADS) {  // per (row, head or pad)
      const int r = i / NP, h = i % NP;
      float dd = 0.f;
      if (h < A.H) {
        float sm = 0.f;
        for (int c = h * C; c < (h + 1) * C; ++c) sm += sf[r * (HC + 4) + c];
        const float den = den_at<T, HC, DG>(A, sAgg, row0, r, h);
        const float dinv = 1.f / fmaxf(den, DEN_FLOOR);
        dd = den > DEN_FLOOR ? -sm * (dinv * dinv) : 0.f;
      }
      if (HC + h < W)
        sAgg[r * SW + HC + h] = from_f<T>(dd);
      else if (row0 + r < A.M)
        A.out[(size_t)(row0 + r) * A.lda + HC + h] = from_f<T>(dd);
    }
    __syncthreads();
    store_tile(A, row0, sAgg, SW, W, A.out, A.lda);
    __syncthreads();
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * HC; i += THREADS) {  // the groups' tables in order
    float v = csum0[i];
    for (int q = 1; q < WG; ++q) v += csum0[q * 8 * HC + i];
    A.part_small[(size_t)blockIdx.x * 8 * HC + i] = v;
  }
}

// K3b: part[run][ch][l] = hin[run][l][rows of ch]^T @ dp[run][l][rows of ch]
// on a BT x BT output tile (BT = 128 where it divides HC, else 64); blockIdx.x =
// (((run * nch + ch) * L + l) * nt + ti) * nt + tj with nt = HC / BT, so
// the tiles of one chunk run side by side and share its rows in L2. 8
// warps, each (BT / 2) x (BT / 4) of the tile; the rows come in steps of
// 32, copied with cp.async into one of two stages while the warps multiply
// with the other (rows past the chunk are zero-filled).
constexpr int DW_THREADS = 256;

template <typename T, int BT>
__host__ __device__ constexpr size_t dw_smem_bytes() {
  return (size_t)2 * 32 * (BT + 8) * (sizeof(T) + 4);
}

template <typename T, int BT>
__global__ void __launch_bounds__(DW_THREADS)
dw_partial_kernel(const T* __restrict__ hin, const float* __restrict__ dp, int M, int HC,
                  int L, int nch, int chunk_rows, float* __restrict__ part) {
  constexpr int LD = BT + 8;       // conflict-free fragment reads
  constexpr int XT = BT / 32;      // m16 tiles of a warp along i
  constexpr int YT = BT / 32;      // n8 tiles of a warp along j
  constexpr int VA = 16 / sizeof(T), VB = 4;  // elements per 16-byte copy
  extern __shared__ __align__(16) char smem[];
  T* As = reinterpret_cast<T*>(smem);                                     // [2][32][LD]
  float* Bs = reinterpret_cast<float*>(smem + 2 * 32 * LD * sizeof(T));  // [2][32][LD]
  const int nt = HC / BT;
  int b = blockIdx.x;
  const int tj = b % nt;
  b /= nt;
  const int ti = b % nt;
  b /= nt;
  const int l = b % L;
  b /= L;
  const int ch = b % nch, run = b / nch;
  const int i0 = ti * BT, j0 = tj * BT;
  hin += ((size_t)run * L + l) * M * HC;
  dp += ((size_t)run * L + l) * M * HC;
  part += (((size_t)run * nch + ch) * L + l) * HC * HC;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
  const int wi = (warp >> 2) * (BT / 2), wj = (warp & 3) * (BT / 4);
  float acc[XT][YT][4];
#pragma unroll
  for (int x = 0; x < XT; ++x)
#pragma unroll
    for (int y = 0; y < YT; ++y)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[x][y][e] = 0.f;
  const int r_begin = ch * chunk_rows;
  const int r_end = min(M, r_begin + chunk_rows);
  const int nsteps = (r_end - r_begin + 31) / 32;
  auto load = [&](int st, int r0) {
    T* a = As + st * 32 * LD;
    float* bb = Bs + st * 32 * LD;
    for (int i = threadIdx.x; i < 32 * (BT / VA); i += DW_THREADS) {
      const int rr = i / (BT / VA), c = i % (BT / VA), r = r0 + rr;
      cp16z(a + rr * LD + c * VA, hin + (size_t)(r < r_end ? r : r_begin) * HC + i0 + c * VA,
            r < r_end);
    }
    for (int i = threadIdx.x; i < 32 * (BT / VB); i += DW_THREADS) {
      const int rr = i / (BT / VB), c = i % (BT / VB), r = r0 + rr;
      cp16z(bb + rr * LD + c * VB, dp + (size_t)(r < r_end ? r : r_begin) * HC + j0 + c * VB,
            r < r_end);
    }
  };
  if (nsteps > 0) {
    load(0, r_begin);
    cp_commit();
  }
#pragma unroll 1
  for (int st = 0; st < nsteps; ++st) {
    if (st + 1 < nsteps) {
      load((st + 1) & 1, r_begin + 32 * (st + 1));
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* a = As + (st & 1) * 32 * LD;
    const float* bb = Bs + (st & 1) * 32 * LD;
#pragma unroll
    for (int kk = 0; kk < 32; kk += 8) {
      uint32_t bh[YT][2], bl[YT][2];
#pragma unroll
      for (int y = 0; y < YT; ++y) {
        split_tf32(bb[(kk + t) * LD + wj + 8 * y + g], bh[y][0], bl[y][0]);
        split_tf32(bb[(kk + t + 4) * LD + wj + 8 * y + g], bh[y][1], bl[y][1]);
      }
#pragma unroll
      for (int x = 0; x < XT; ++x) {
        const int im = wi + 16 * x + g;
        const float av[4] = {to_f(a[(kk + t) * LD + im]), to_f(a[(kk + t) * LD + im + 8]),
                             to_f(a[(kk + t + 4) * LD + im]),
                             to_f(a[(kk + t + 4) * LD + im + 8])};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(av[q], ah[q], al[q]);
#pragma unroll
        for (int y = 0; y < YT; ++y) {
          if (sizeof(T) == 4) mma_tf32(acc[x][y], al, bh[y]);  // bf16 h: al == 0
          mma_tf32(acc[x][y], ah, bl[y]);
          mma_tf32(acc[x][y], ah, bh[y]);
        }
      }
    }
    __syncthreads();  // this stage is refilled in the next iteration
  }
#pragma unroll
  for (int x = 0; x < XT; ++x)
#pragma unroll
    for (int y = 0; y < YT; ++y)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + wi + 16 * x + g + 8 * h, j = j0 + wj + 8 * y + 2 * t;
        store2(part + (size_t)i * HC + j, acc[x][y][2 * h], acc[x][y][2 * h + 1]);
      }
}

// K3c: out[run][j] = sum_p part[run][p][j], in order of p (run = blockIdx.y).
__global__ void reduce_partials_kernel(const float* __restrict__ part, int P,
                                       int N, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  part += (size_t)blockIdx.y * P * N;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += part[(size_t)p * N + j];
  out[(size_t)blockIdx.y * N + j] = s;
}

// The opt-in shared memory of a block on the H100. The denominators are
// staged unless that would overflow it; at H = HC (the widest stage) that
// happens only for f32 at HC = 256, so only there is DG instantiated.
constexpr size_t SMEM_MAX = 227 * 1024;

template <typename T, int HC>
constexpr bool den_may_overflow() {
  return smem_bytes<T>(HC, true, agg_width<HC, false>(HC)) > SMEM_MAX;
}

template <typename T, int HC, bool DG>
int launch_fwd_as(const Args<T>& A, int R, cudaStream_t s) {
  const size_t bytes = smem_bytes<T>(HC, false, agg_width<HC, DG>(A.H));
  cudaError_t e = cudaFuncSetAttribute(pma_fwd_kernel<T, HC, DG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  pma_fwd_kernel<T, HC, DG><<<dim3((A.M + TM - 1) / TM, R), THREADS, bytes, s>>>(A);
  return (int)cudaGetLastError();
}

template <typename T, int HC>
int launch_fwd(const Args<T>& A, int R, cudaStream_t s) {
  if constexpr (den_may_overflow<T, HC>())
    if (smem_bytes<T>(HC, false, agg_width<HC, false>(A.H)) > SMEM_MAX)
      return launch_fwd_as<T, HC, true>(A, R, s);
  return launch_fwd_as<T, HC, false>(A, R, s);
}

template <typename T, int HC, bool DG>
int launch_bwd_rows(const Args<T>& A, int R, int grid_rows, cudaStream_t s) {
  const size_t bytes = smem_bytes<T>(HC, true, agg_width<HC, DG>(A.H));
  cudaError_t e = cudaFuncSetAttribute(pma_bwd_rows_kernel<T, HC, DG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  pma_bwd_rows_kernel<T, HC, DG><<<dim3(grid_rows, R), THREADS, bytes, s>>>(A);
  return (int)cudaGetLastError();
}

template <typename T, int HC>
int launch_bwd(const Args<T>& A, int R, float* dW, float* dsmall, float* part_w,
               int grid_rows, int nch, int chunk_rows, cudaStream_t s) {
  int rc;
  if constexpr (den_may_overflow<T, HC>())
    rc = smem_bytes<T>(HC, true, agg_width<HC, false>(A.H)) > SMEM_MAX
             ? launch_bwd_rows<T, HC, true>(A, R, grid_rows, s)
             : launch_bwd_rows<T, HC, false>(A, R, grid_rows, s);
  else
    rc = launch_bwd_rows<T, HC, false>(A, R, grid_rows, s);
  if (rc != (int)cudaSuccess) return rc;
  constexpr int BT = HC % 128 == 0 ? 128 : 64;
  constexpr size_t dw_bytes = dw_smem_bytes<T, BT>();
  cudaError_t e = cudaFuncSetAttribute(dw_partial_kernel<T, BT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dw_bytes);
  if (e != cudaSuccess) return (int)e;
  const int nt = HC / BT;
  dw_partial_kernel<T, BT><<<(unsigned)R * nch * A.L * nt * nt, DW_THREADS, dw_bytes, s>>>(
      A.hin, A.dpbuf, A.M, HC, A.L, nch, chunk_rows, part_w);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int nw = A.L * HC * HC, ns = 8 * HC;
  reduce_partials_kernel<<<dim3((nw + 255) / 256, R), 256, 0, s>>>(part_w, nch, nw, dW);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  reduce_partials_kernel<<<dim3((ns + 255) / 256, R), 256, 0, s>>>(A.part_small, grid_rows,
                                                                   ns, dsmall);
  return (int)cudaGetLastError();
}

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

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (agg, gy, out, dagg). Parameters are
// float32; Wf [R, L, HC, HC] f32 ([in][out]); Wbt the same weights in
// bf16, transposed ([out][in]), on the bf16 path (null in f32). R runs
// folded into the width (R = 1: the single-run layout); WP is the per-run
// width. Returns 1 (cudaErrorInvalidValue) for an unsupported HC.
int allset_pma_epilogue_fwd(const void* agg, const void* seed, const void* g0,
                            const void* b0, const void* Wf, const void* Wbt,
                            const void* brff, const void* g1, const void* b1, void* out,
                            int M, int WP, int HC, int H, int L, int R, int relu, int dtype,
                            void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || R <= 0) return (int)cudaGetLastError();
#define FWD(T, HCV)                                                                        \
  if (HC == HCV)                                                                           \
    return launch_fwd<T, HCV>(make_args<T>(agg, nullptr, seed, g0, b0, Wf, Wbt, brff, g1, \
                                           b1, out, nullptr, nullptr, nullptr, M, WP, HC, \
                                           H, L, R, relu),                                \
                              R, s);
  if (dtype == 0) {
    FWD(float, 64) FWD(float, 128) FWD(float, 192) FWD(float, 256)
  } else {
    FWD(__nv_bfloat16, 64) FWD(__nv_bfloat16, 128) FWD(__nv_bfloat16, 192)
    FWD(__nv_bfloat16, 256)
  }
#undef FWD
  return (int)cudaErrorInvalidValue;
}

// Scratch (allocated by the caller), per run: hin [R, L, M, HC] dtype,
// dpbuf [R, L, M, HC] f32, part_small [R, grid_rows, 8, HC] f32,
// part_w [R, nch, L, HC, HC] f32.
int allset_pma_epilogue_bwd(const void* agg, const void* gy, const void* seed,
                            const void* g0, const void* b0, const void* Wf,
                            const void* Wbt, const void* brff, const void* g1,
                            const void* b1, void* dagg, void* dW, void* dsmall,
                            void* hin, void* dpbuf, void* part_small,
                            void* part_w, int M, int WP, int HC, int H, int L,
                            int R, int relu, int dtype, int grid_rows, int nch,
                            int chunk_rows, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || R <= 0) return (int)cudaGetLastError();
#define BWD(T, HCV)                                                                         \
  if (HC == HCV)                                                                            \
    return launch_bwd<T, HCV>(make_args<T>(agg, gy, seed, g0, b0, Wf, Wbt, brff, g1, b1,   \
                                           dagg, hin, dpbuf, part_small, M, WP, HC, H, L, \
                                           R, relu),                                       \
                              R, static_cast<float*>(dW), static_cast<float*>(dsmall),     \
                              static_cast<float*>(part_w), grid_rows, nch, chunk_rows, s);
  if (dtype == 0) {
    BWD(float, 64) BWD(float, 128) BWD(float, 192) BWD(float, 256)
  } else {
    BWD(__nv_bfloat16, 64) BWD(__nv_bfloat16, 128) BWD(__nv_bfloat16, 192)
    BWD(__nv_bfloat16, 256)
  }
#undef BWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
