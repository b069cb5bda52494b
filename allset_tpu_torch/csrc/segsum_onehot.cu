// B1-B4, B6: the one-hot tensor-core segment-sum experiments.
//
// Replaces the TPU round's sorted segment-sum prototypes:
//   B1 benchmarks/pallas_segsum_proto.py::make_kernel (the prototype),
//   B2 benchmarks/exp_nbuf.py::_kernel (NBUF-deep buffers),
//   B3 benchmarks/exp_acc2.py::_kernel (NACC accumulators),
//   B4 benchmarks/exp_onehot.py::_kernel (three one-hot builds),
//   B6 benchmarks/exp_segsum_ablate.py::_kernel (ablation modes).
// Each computes, for every block b of S_BLK segments, with start =
// block_indptr[b], end = block_indptr[b + 1], start_al = start rounded
// down to 128 and nchunks = cdiv(end - start_al, CHUNK):
//   acc[s] += sum_r onehot[s, r] * msgs[start_al + c CHUNK + r]
// over the chunks c, onehot[s, r] = (dst[row] - b S_BLK == s) ("full"):
// rows outside the block's segments drop out through the compare, as the
// 128-aligned start makes them do on the TPU. out[b S_BLK + s] = acc[s],
// f32. The ablation modes keep B6's surrogates exactly:
//   noonehot: onehot[s, r] = (r % S_BLK == s) (a constant one-hot, here
//             computed from the row index in registers: no ids read);
//   nomatmul: acc[s] += msgs[off + s] + (dst[off + s] == b S_BLK), s <
//             S_BLK (the one-hot's first column, no product);
//   dmaonly:  acc[s] += msgs[off + s], s < S_BLK; "depth4" the same at 4
//             stages (B6 multiplies only in "full" and "noonehot");
//             "nodst", "nodst4" without copying the ids, at 2 and 4.
// A row past the end of msgs reads as zeros with no id.
//
// On the H100 "full" is bound by bytes (each message row read once, each
// segment row written once); the one-hot product's 2 S_BLK operations per
// element are far under the tensor cores' rate at S_BLK <= 256. Not
// carried over block by block:
//   * the TPU's sequential grid over the block's chunks is a loop inside
//     one thread block; the grid is (blocks, F / FT) column tiles, since
//     an S_BLK 256 x F 384 f32 accumulator (384 KB) fits no SM;
//   * msgs rows and ids are staged through a cp.async ring of NBUF stages
//     of 64 rows (a chunk is CHUNK / 64 stages; NBUF chunk-sized buffers
//     would need up to 1.5 MB);
//   * products on the tensor cores with mma.sync: bf16 m16n8k16 with f32
//     sums (the one-hot is exact in bf16, so each product is exact); f32
//     inputs as 3xTF32 reduced to two products, onehot x hi(x) and onehot
//     x lo(x), since the one-hot's own low part is zero (about 2^-21 of
//     each element is lost);
//   * NACC accumulator sets in registers, chunk c into set c % NACC, added
//     in order at the end; the column tile narrows as NACC grows (at most
//     64 accumulator registers a thread);
//   * the one-hot builds: A writes each stage's whole [S_BLK, 64] one-hot
//     to shared memory and reads the mma fragments from there; B writes
//     it one 16-entry (bf16; 8 for f32) k-slice at a time, two barriers a
//     slice; C builds the fragments in registers straight from the ids.
// 8 warps: 4 over the block's segments (MT m-tiles of 16 each) by 2 over
// the tile's columns (NT n-tiles of 8 each).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsM = 4, kWarpsN = 2;
constexpr int kSR = 64;  // rows of a pipeline stage

enum Mode { FULL = 0, NOONEHOT = 1, NOMATMUL = 2, DMAONLY = 3 };
enum Build { BUILD_A = 0, BUILD_B = 1, BUILD_C = 2 };

template <typename T>
struct Elt;
template <>
struct Elt<__nv_bfloat16> {
  static constexpr int K = 16, PAD = 8;  // mma depth; row padding (elements)
};
template <>
struct Elt<float> {
  static constexpr int K = 8, PAD = 4;
};

template <typename T, int MT, int NACC>
struct Cfg {
  static constexpr int S_BLK = kWarpsM * 16 * MT;
  static constexpr int NT0 = 16 / (MT * NACC);
  static constexpr int NT = NT0 < 1 ? 1 : (NT0 > 4 ? 4 : NT0);
  static constexpr int FT = kWarpsN * NT * 8;  // the block's columns
  static constexpr int K = Elt<T>::K;
  static constexpr int LDC = FT + Elt<T>::PAD;   // a staged msgs row (elements)
  static constexpr int LDA = kSR + Elt<T>::PAD;  // a one-hot row (elements)
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes, zero-filled where !valid (src is not read then)
__device__ __forceinline__ void cp16z(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp4z(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// until at most nbuf - 2 groups are pending: stage q has landed
__device__ __forceinline__ void cp_wait_stage(int nbuf) {
  switch (nbuf) {
    case 2: cp_wait<0>(); break;
    case 3: cp_wait<1>(); break;
    case 4: cp_wait<2>(); break;
    default: cp_wait<4>(); break;  // 6
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b,
                                    __nv_bfloat16) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b, float) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void set_one(float* p, bool on) { *p = on ? 1.f : 0.f; }
__device__ __forceinline__ void set_one(__nv_bfloat16* p, bool on) {
  *p = __float2bfloat16_rn(on ? 1.f : 0.f);
}

// one-hot fragment words: bf16 pairs (low half = lower k) or one tf32
__device__ __forceinline__ uint32_t oh2(bool lo, bool hi) {
  return (lo ? 0x3F80u : 0u) | (hi ? 0x3F800000u : 0u);
}
__device__ __forceinline__ uint32_t oh1(bool on) { return on ? 0x3F800000u : 0u; }

struct Args {
  const void* msgs;
  const int* dst;
  const int* bip;  // block_indptr
  long long nrows;
  int F, chunk, nbuf, mode, build, load_ids;
  float* out;
};

template <typename T, int MT, int NACC>
struct Block {
  using C = Cfg<T, MT, NACC>;
  static constexpr int S_BLK = C::S_BLK, NT = C::NT, FT = C::FT, K = C::K;
  static constexpr int LDC = C::LDC, LDA = C::LDA;

  const Args a;
  T* ms;    // [nbuf][kSR][LDC]
  int* ds;  // [nbuf][kSR]
  T* oh;    // [S_BLK][LDA]
  int b, col0, base, start_al, wm, wn, g, t;

  __device__ Block(const Args& args, unsigned char* smem)
      : a(args), b(blockIdx.x), col0(blockIdx.y * FT), base(blockIdx.x * S_BLK) {
    ms = reinterpret_cast<T*>(smem);
    ds = reinterpret_cast<int*>(smem + (size_t)a.nbuf * kSR * LDC * sizeof(T));
    oh = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(ds) + (size_t)a.nbuf * kSR * 4);
    const int warp = threadIdx.x >> 5;
    wm = warp / kWarpsN;
    wn = warp % kWarpsN;
    g = (threadIdx.x >> 2) & 7;
    t = threadIdx.x & 3;
  }

  __device__ long long stage_row(int q) const {
    const int spc = a.chunk / kSR;
    return (long long)start_al + (long long)(q / spc) * a.chunk + (long long)(q % spc) * kSR;
  }

  __device__ void load(int q, int slot) {
    constexpr int EV = 16 / sizeof(T), VPR = FT / EV;  // elements a vector, vectors a row
    const long long row0 = stage_row(q);
    const T* msgs = static_cast<const T*>(a.msgs);
    T* dst = ms + (size_t)slot * kSR * LDC;
    for (int i = threadIdx.x; i < kSR * VPR; i += kThreads) {
      const int r = i / VPR, v = i % VPR;
      const bool ok = row0 + r < a.nrows;
      cp16z(dst + r * LDC + v * EV, msgs + (ok ? row0 + r : 0) * a.F + col0 + v * EV, ok);
    }
    if (a.load_ids && threadIdx.x < kSR) {
      const bool ok = row0 + threadIdx.x < a.nrows;
      cp4z(ds + slot * kSR + threadIdx.x, a.dst + (ok ? row0 + threadIdx.x : 0), ok);
    }
  }

  // the relative id of row kx of the stage (-1: past the end of msgs)
  __device__ int rel(int slot, long long row0, int kx) const {
    return row0 + kx < a.nrows ? ds[slot * kSR + kx] - base : -1;
  }

  // the one-hot's columns [k0, k0 + n) of this stage, in shared memory
  __device__ void build_oh(int slot, long long row0, int k0, int n) {
    for (int i = threadIdx.x; i < S_BLK * n; i += kThreads) {
      const int s = i / n, kx = k0 + i % n;
      set_one(oh + s * LDA + kx, rel(slot, row0, kx) == s);
    }
  }

  __device__ void a_frag(uint32_t* af, int mt, int slot, long long row0, int kb, int rc0) const {
    const int s0 = (wm * MT + mt) * 16 + g, s1 = s0 + 8;
    if constexpr (K == 16) {  // bf16: rows s0, s1; k 2t, 2t+1 and 2t+8, 2t+9
      const int k[4] = {kb + 2 * t, kb + 2 * t + 1, kb + 2 * t + 8, kb + 2 * t + 9};
      if (a.mode == NOONEHOT || a.build == BUILD_C) {
        int r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = a.mode == NOONEHOT ? (rc0 + k[i]) % S_BLK : rel(slot, row0, k[i]);
        af[0] = oh2(r[0] == s0, r[1] == s0);
        af[1] = oh2(r[0] == s1, r[1] == s1);
        af[2] = oh2(r[2] == s0, r[3] == s0);
        af[3] = oh2(r[2] == s1, r[3] == s1);
      } else {
        af[0] = *reinterpret_cast<const uint32_t*>(oh + s0 * LDA + k[0]);
        af[1] = *reinterpret_cast<const uint32_t*>(oh + s1 * LDA + k[0]);
        af[2] = *reinterpret_cast<const uint32_t*>(oh + s0 * LDA + k[2]);
        af[3] = *reinterpret_cast<const uint32_t*>(oh + s1 * LDA + k[2]);
      }
    } else {  // tf32: rows s0, s1; k t and t+4
      const int k0 = kb + t, k1 = kb + t + 4;
      if (a.mode == NOONEHOT || a.build == BUILD_C) {
        const int r0 = a.mode == NOONEHOT ? (rc0 + k0) % S_BLK : rel(slot, row0, k0);
        const int r1 = a.mode == NOONEHOT ? (rc0 + k1) % S_BLK : rel(slot, row0, k1);
        af[0] = oh1(r0 == s0);
        af[1] = oh1(r0 == s1);
        af[2] = oh1(r1 == s0);
        af[3] = oh1(r1 == s1);
      } else {
        af[0] = *reinterpret_cast<const uint32_t*>(oh + s0 * LDA + k0);
        af[1] = *reinterpret_cast<const uint32_t*>(oh + s1 * LDA + k0);
        af[2] = *reinterpret_cast<const uint32_t*>(oh + s0 * LDA + k1);
        af[3] = *reinterpret_cast<const uint32_t*>(oh + s1 * LDA + k1);
      }
    }
  }

  // the products of one stage into acc: one-hot^T [S_BLK, 64] x msgs [64, FT]
  __device__ void products(float (&acc)[MT][NT][4], int slot, long long row0, int rc0) {
    const T* m = ms + (size_t)slot * kSR * LDC;
    const bool per_slice = a.mode == FULL && a.build == BUILD_B;
    for (int kb = 0; kb < kSR; kb += K) {
      if (per_slice) {
        build_oh(slot, row0, kb, K);
        __syncthreads();
      }
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = (wn * NT + nt) * 8 + g;
        if constexpr (K == 16) {
          const unsigned short* u = reinterpret_cast<const unsigned short*>(m);
          bh[nt][0] = u[(kb + 2 * t) * LDC + n] | ((uint32_t)u[(kb + 2 * t + 1) * LDC + n] << 16);
          bh[nt][1] = u[(kb + 2 * t + 8) * LDC + n] |
                      ((uint32_t)u[(kb + 2 * t + 9) * LDC + n] << 16);
        } else {
          const float* f = reinterpret_cast<const float*>(m);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float x = f[(kb + t + 4 * h) * LDC + n];
            bh[nt][h] = tf32(x);
            bl[nt][h] = tf32(__fsub_rn(x, __uint_as_float(bh[nt][h])));
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        a_frag(af, mt, slot, row0, kb, rc0);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if constexpr (K == 8) mma(acc[mt][nt], af, bl[nt], T());  // the low part first
          mma(acc[mt][nt], af, bh[nt], T());
        }
      }
      if (per_slice) __syncthreads();
    }
  }

  // nomatmul / dmaonly: acc[s] += msgs[off + s] (+ the one-hot's column 0)
  __device__ void surrogate(float (&acc)[MT][NT][4], int slot, long long row0, int s_lo) {
    if (s_lo >= S_BLK) return;
    const T* m = ms + (size_t)slot * kSR * LDC;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = (wm * MT + mt) * 16 + g + 8 * (e >> 1), r = s - s_lo;
        if (r < 0 || r >= kSR) continue;
        const float ind = a.mode == NOMATMUL && rel(slot, row0, r) == 0 ? 1.f : 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float x = to_f(m[r * LDC + (wn * NT + nt) * 8 + 2 * t + (e & 1)]);
          acc[mt][nt][e] += a.mode == NOMATMUL ? x + ind : x;
        }
      }
  }

  __device__ void stage(float (&acc)[MT][NT][4], int q, int slot) {
    const int spc = a.chunk / kSR, rc0 = (q % spc) * kSR;  // the stage's first chunk row
    const long long row0 = stage_row(q);
    if (a.mode == FULL || a.mode == NOONEHOT) {
      if (a.mode == FULL && a.build == BUILD_A) {
        build_oh(slot, row0, 0, kSR);
        __syncthreads();
      }
      products(acc, slot, row0, rc0);
    } else {
      surrogate(acc, slot, row0, rc0);
    }
  }

  __device__ void run() {
    const int start = a.bip[b], end = a.bip[b + 1];
    start_al = start / 128 * 128;
    const int nchunks = end > start_al ? (end - start_al + a.chunk - 1) / a.chunk : 0;
    const int nst = nchunks * (a.chunk / kSR);
    float acc[NACC][MT][NT][4];
#pragma unroll
    for (int i = 0; i < NACC; ++i)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][mt][nt][e] = 0.f;
    for (int i = 0; i < a.nbuf - 1; ++i) {
      if (i < nst) load(i, i);
      cp_commit();
    }
    for (int q = 0; q < nst; ++q) {
      cp_wait_stage(a.nbuf);
      __syncthreads();  // stage q landed for all; stage q - 1's reads are done
      if (q + a.nbuf - 1 < nst) load(q + a.nbuf - 1, (q + a.nbuf - 1) % a.nbuf);
      cp_commit();
      const int set = (q / (a.chunk / kSR)) % NACC;
#pragma unroll
      for (int i = 0; i < NACC; ++i)
        if (i == set) stage(acc[i], q, q % a.nbuf);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[0][mt][nt][2 * h], v1 = acc[0][mt][nt][2 * h + 1];
#pragma unroll
          for (int i = 1; i < NACC; ++i) {
            v0 += acc[i][mt][nt][2 * h];
            v1 += acc[i][mt][nt][2 * h + 1];
          }
          const int s = (wm * MT + mt) * 16 + g + 8 * h;
          const int col = col0 + (wn * NT + nt) * 8 + 2 * t;
          *reinterpret_cast<float2*>(a.out + (size_t)(base + s) * a.F + col) =
              make_float2(v0, v1);
        }
  }
};

template <typename T, int MT, int NACC>
__global__ void __launch_bounds__(kThreads) segsum_onehot_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  Block<T, MT, NACC> blk(args, smem);
  blk.run();
}

template <typename T, int MT, int NACC>
int launch(const Args& args, int num_blocks, cudaStream_t s) {
  using C = Cfg<T, MT, NACC>;
  if (args.F % C::FT) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)args.nbuf * kSR * (C::LDC * sizeof(T) + 4) +
                       (args.mode == FULL && args.build != BUILD_C
                            ? (size_t)C::S_BLK * C::LDA * sizeof(T)
                            : 0);
  cudaError_t e = cudaFuncSetAttribute(segsum_onehot_kernel<T, MT, NACC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (num_blocks > 0)
    segsum_onehot_kernel<T, MT, NACC>
        <<<dim3((unsigned)num_blocks, (unsigned)(args.F / C::FT)), kThreads, bytes, s>>>(args);
  return (int)cudaGetLastError();
}

template <typename T, int MT>
int launch_nacc(const Args& args, int nacc, int num_blocks, cudaStream_t s) {
  if (nacc == 1) return launch<T, MT, 1>(args, num_blocks, s);
  if (nacc == 2) return launch<T, MT, 2>(args, num_blocks, s);
  if (nacc == 4) return launch<T, MT, 4>(args, num_blocks, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_sblk(const Args& args, int s_blk, int nacc, int num_blocks, cudaStream_t s) {
  if (s_blk == 64) return launch_nacc<T, 1>(args, nacc, num_blocks, s);
  if (s_blk == 128) return launch_nacc<T, 2>(args, nacc, num_blocks, s);
  if (s_blk == 256) return launch_nacc<T, 4>(args, nacc, num_blocks, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// msgs [nrows, F] (dtype 0 = f32, 1 = bf16), dst [nrows] int32, block_indptr
// [num_blocks + 1] int32, out [num_blocks * s_blk, F] f32. s_blk in {64,
// 128, 256}, nacc in {1, 2, 4}, nbuf in {2, 3, 4, 6}, chunk a multiple of
// 64, F a multiple of 64; mode and build as the enums above; load_ids 0
// for the modes that copy no ids. Returns cudaGetLastError().
int allset_segsum_onehot(const void* msgs, const void* dst, const void* block_indptr,
                         long long nrows, int num_blocks, int F, int s_blk, int chunk, int nbuf,
                         int nacc, int mode, int build, int load_ids, void* out, int dtype,
                         void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (chunk <= 0 || chunk % kSR || F <= 0 || F % 64 || mode < FULL || mode > DMAONLY ||
      build < BUILD_A || build > BUILD_C || (nbuf != 2 && nbuf != 3 && nbuf != 4 && nbuf != 6))
    return (int)cudaErrorInvalidValue;
  const Args args{msgs, static_cast<const int*>(dst), static_cast<const int*>(block_indptr),
                  nrows, F, chunk, nbuf, mode, build, load_ids, static_cast<float*>(out)};
  if (dtype == 0) return launch_sblk<float>(args, s_blk, nacc, num_blocks, s);
  return launch_sblk<__nv_bfloat16>(args, s_blk, nacc, num_blocks, s);
}

}  // extern "C"
