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
//   * the TPU's sequential grid over a block's chunks: a block's window is
//     cut into work items of at most cpi chunks (item_rows rows), so a hub
//     block (on the bench graph's node side one block holds 92% of the
//     entries) spreads over many thread blocks instead of running in series
//     on one. A plan kernel (one thread block) counts each block's items
//     from block_indptr on the device (a scan) and writes an item map; the
//     grid, sized on the host from the row count, the block count and the
//     chunk alone, walks it (surplus thread blocks exit). A block of one
//     item writes out; the items of a split block each write an f32
//     partial of the segment rows they reached, and a second pass adds
//     them in item order, in parallel over (split block, m-tile, column
//     tile) units: the same bits at every launch;
//   * a thread block takes one column tile (F / FT columns) of an item,
//     since an S_BLK 256 x F 384 f32 accumulator (384 KB) fits no SM; the
//     tiles of an item are neighbours in the grid, so they run side by
//     side and read the same rows together;
//   * an item's ids are staged first, whole: they give each 64-row stage
//     the span of segments its rows reach (in "full" the stage's least and
//     greatest id in the block; in "noonehot" r % S_BLK of its rows), and
//     in "full" stages whose rows reach no segment of the block are not
//     loaded at all and rows of other blocks are zero-filled rather than
//     read. The msgs rows then go through a cp.async ring of NBUF stages;
//   * products on the tensor cores with mma.sync, only on the m-tiles
//     (16 segments) inside the stage's span: bf16 m16n8k16 with f32 sums
//     (the one-hot is exact in bf16, so each product is exact; B fragments
//     by ldmatrix.trans); f32 inputs as 3xTF32 reduced to two products,
//     onehot x hi(x) and onehot x lo(x), since the one-hot's own low part
//     is zero (about 2^-21 of each element is lost). A stage's products
//     on an m-tile start from zero and are added to the accumulator in
//     f32: the tensor cores' own f32 accumulation, carried over thousands
//     of rows of a hub segment, drifted by about 1e-5 of the sum (items of
//     4,096 rows, f32);
//   * NACC accumulator sets in registers, chunk c of the block's window
//     (counted from start_al, not from the item) into set c % NACC, added
//     in order at the end of the item; the column tile narrows as NACC
//     grows (at most 64 accumulator registers a thread);
//   * the one-hot builds: A writes each stage's one-hot rows of the span
//     ([span, 64]) to shared memory and reads the mma fragments from
//     there; B writes them one 16-entry (bf16; 8 for f32) k-slice at a
//     time, two barriers a slice; C builds the fragments in registers
//     straight from the ids.
// 8 warps: 4 over the block's m-tiles, interleaved (warp row wm owns
// m-tiles wm, wm + 4, ...: a span of contiguous m-tiles falls on
// different warps), by 2 over the tile's columns (NT n-tiles of 8 each).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsM = 4, kWarpsN = 2;
constexpr int kSR = 64;              // rows of a pipeline stage
constexpr int kMaxItemRows = 4096;   // an item's staged ids (16 KB)
constexpr int kMaxStages = kMaxItemRows / kSR;
constexpr int kPlanThreads = 1024;
constexpr int kCombineBlocks = 264;  // the second pass's grid (two waves of 132 SMs)
constexpr int kEmpty = 0xFFFF;       // a span reaching no m-tile: lo 0xFFFF, hi -1

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
  // thread blocks an SM: three where the accumulators take 16 registers a
  // thread (S_BLK 64, one set; 7% faster for B1), else two (64 registers;
  // at 80 registers a thread those spill)
  static constexpr int MIN_BLOCKS = NACC * MT * NT <= 4 ? 3 : 2;
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

// B fragments of two n-tiles (x4) or one (x2) for 16 k rows of a
// row-major [k][n] bf16 tile: lane l addresses row (l & 7) + 8 ((l >> 3) & 1)
// at column 8 (l >> 4)
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// one-hot fragment words: bf16 pairs (low half = lower k) or one tf32
__device__ __forceinline__ uint32_t oh2(bool lo, bool hi) {
  return (lo ? 0x3F80u : 0u) | (hi ? 0x3F800000u : 0u);
}
__device__ __forceinline__ uint32_t oh1(bool on) { return on ? 0x3F800000u : 0u; }

// a span of m-tiles [lo, hi] packed in one int; empty: lo > hi
__device__ __forceinline__ int span_pack(int lo, int hi) {
  return (int)(((unsigned)hi << 16) | (unsigned)(lo & 0xFFFF));
}
__device__ __forceinline__ int span_lo(int v) { return v & 0xFFFF; }
__device__ __forceinline__ int span_hi(int v) { return v >> 16; }

struct Item {  // one work item: block b's chunks [j cpi, ...); a split block: j unused
  int b, j, nitems, slot;  // slot: the block's first partial (-1: one item; -2: no room)
};

struct Args {
  const void* msgs;
  const int* dst;
  const int* bip;  // block_indptr
  long long nrows;
  int F, chunk, nbuf, mode, build, load_ids, cpi;
  const int* total;  // items in the map (from the plan kernel)
  const Item* items;
  int* spans;    // [slots][F / FT]: the segment rows each split item wrote
  float* part;   // [slots][S_BLK][F]
  float* out;
};

// the chunks of block b's window: from start rounded down to 128 to
// min(end, nrows), whole chunks
__device__ __forceinline__ int window_chunks(const int* bip, int b, long long nrows, int chunk,
                                             long long* start_al) {
  const long long start = bip[b];
  const long long end = min((long long)bip[b + 1], nrows);
  *start_al = start / 128 * 128;
  return end > *start_al ? (int)((end - *start_al + chunk - 1) / chunk) : 0;
}

// exclusive block scan of (x, y) over kPlanThreads threads; returns the totals
__device__ int2 scan2(int& x, int& y, int2* warp_tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int ix = x, iy = y;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int ux = __shfl_up_sync(0xffffffffu, ix, d), uy = __shfl_up_sync(0xffffffffu, iy, d);
    if (lane >= d) {
      ix += ux;
      iy += uy;
    }
  }
  if (lane == 31) warp_tot[w] = make_int2(ix, iy);
  __syncthreads();
  if (w == 0) {
    int2 v = warp_tot[lane];
    int sx = v.x, sy = v.y;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int ux = __shfl_up_sync(0xffffffffu, sx, d), uy = __shfl_up_sync(0xffffffffu, sy, d);
      if (lane >= d) {
        sx += ux;
        sy += uy;
      }
    }
    warp_tot[lane] = make_int2(sx - v.x, sy - v.y);  // exclusive
    if (lane == 31) warp_tot[32] = make_int2(sx, sy);
  }
  __syncthreads();
  const int2 off = warp_tot[w], tot = warp_tot[32];
  x = off.x + ix - x;
  y = off.y + iy - y;
  __syncthreads();  // warp_tot is reused
  return tot;
}

// the work plan: block b's window in max(1, cdiv(chunks, cpi)) items, in
// block order; a split block's items take consecutive partial slots, and
// the split blocks are listed in order for the second pass. hdr: [items,
// split blocks]
__global__ void __launch_bounds__(kPlanThreads)
    plan_kernel(const int* __restrict__ bip, int num_blocks, long long nrows, int chunk, int cpi,
                int cap, int slots_cap, int* hdr, Item* items, Item* splits) {
  __shared__ int2 warp_tot[33];
  int carry_i = 0, carry_s = 0, carry_b = 0;
  for (int b0 = 0; b0 < num_blocks; b0 += kPlanThreads) {
    const int b = b0 + threadIdx.x;
    int n = 0;
    if (b < num_blocks) {
      long long start_al;
      const int nch = window_chunks(bip, b, nrows, chunk, &start_al);
      n = max(1, (nch + cpi - 1) / cpi);
    }
    const bool split = n > 1;
    int ist = n, sst = split ? n : 0, bst = split, unused = 0;
    const int2 tot = scan2(ist, sst, warp_tot);
    const int nsplit = scan2(bst, unused, warp_tot).x;
    int slot = -1;
    if (split) {
      slot = carry_s + sst + n <= slots_cap ? carry_s + sst : -2;
      splits[carry_b + bst] = Item{b, 0, n, slot};
    }
    for (int j = 0; j < n; ++j) {
      const int idx = carry_i + ist + j;
      if (idx < cap) items[idx] = Item{b, j, n, slot};
    }
    carry_i += tot.x;
    carry_s += tot.y;
    carry_b += nsplit;
  }
  if (threadIdx.x == 0) {
    hdr[0] = min(carry_i, cap);
    hdr[1] = carry_b;
  }
}

template <typename T, int MT, int NACC>
struct Block {
  using C = Cfg<T, MT, NACC>;
  static constexpr int S_BLK = C::S_BLK, NT = C::NT, FT = C::FT, K = C::K;
  static constexpr int LDC = C::LDC, LDA = C::LDA, MTT = S_BLK / 16;

  const Args a;
  T* ms;      // [nbuf][kSR][LDC]
  int* rid;   // [item rows]: each row's id relative to the block (-1: no id)
  int* sp;    // [kMaxStages]: each stage's span of m-tiles
  int* act;   // [kMaxStages + 2]: the stages to run; then their count and union span
  T* oh;      // [S_BLK][LDA]
  int b, base, col0, ct, ncol, wm, wn, g, t, lane;
  long long row_first;  // the item's first row

  __device__ Block(const Args& args, unsigned char* smem, int item_rows)
      : a(args), ncol(args.F / FT) {
    ms = reinterpret_cast<T*>(smem);
    rid = reinterpret_cast<int*>(smem + (size_t)a.nbuf * kSR * LDC * sizeof(T));
    sp = rid + item_rows;
    act = sp + kMaxStages;
    oh = reinterpret_cast<T*>(act + kMaxStages + 4);
    const int warp = threadIdx.x >> 5;
    wm = warp / kWarpsN;
    wn = warp % kWarpsN;
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
  }

  __device__ int seg0(int mt) const { return (mt * kWarpsM + wm) * 16; }  // owned m-tile's row
  __device__ bool owned_active(int mt, int span) const {
    const int gm = mt * kWarpsM + wm;
    return gm >= span_lo(span) && gm <= span_hi(span);
  }

  // the row of stage s of the item and its first row within its chunk
  __device__ long long stage_row(int s) const { return row_first + (long long)s * kSR; }
  __device__ int chunk_row(int s) const { return (s % (a.chunk / kSR)) * kSR; }

  // stage the item's ids (relative to the block), each stage's span, and
  // the list of stages to run with the union of their spans
  __device__ void plan_stages(int nrow_item) {
    const int nst = nrow_item / kSR;
    if (a.load_ids) {
      for (int i = threadIdx.x * 4; i < nrow_item; i += kThreads * 4) {
        const long long r = row_first + i;
        if (r + 3 < a.nrows) {
          cp16z(rid + i, a.dst + r, true);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) cp4z(rid + i + k, a.dst + (r + k < a.nrows ? r + k : 0),
                                           r + k < a.nrows);
        }
      }
      cp_commit();
      cp_wait<0>();
      __syncthreads();
    }
    const int warp = threadIdx.x >> 5;
    for (int s = warp; s < nst; s += kThreads / 32) {
      int lo = kEmpty, hi = -1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = s * kSR + lane + 32 * h;
        int r = -1;
        if (a.load_ids) {
          r = stage_row(s) + lane + 32 * h < a.nrows ? rid[k] - base : -1;
          rid[k] = r;
        }
        if (r >= 0 && r < S_BLK) {
          lo = min(lo, r);
          hi = max(hi, r);
        }
      }
      lo = (int)__reduce_min_sync(0xffffffffu, (unsigned)lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0) {
        int v;
        if (a.mode == FULL)
          v = hi < 0 ? span_pack(kEmpty, -1) : span_pack(lo / 16, hi / 16);
        else if (a.mode == NOONEHOT)  // rows r of the chunk into r % S_BLK: 4 m-tiles
          v = span_pack(chunk_row(s) % S_BLK / 16, chunk_row(s) % S_BLK / 16 + kSR / 16 - 1);
        else
          v = span_pack(0, MTT - 1);
        sp[s] = v;
      }
    }
    __syncthreads();
    if (warp == 0) {  // compaction of the stages whose span is not empty
      int n = 0, ulo = kEmpty, uhi = -1;
      for (int s0 = 0; s0 < nst; s0 += 32) {
        const int s = s0 + lane;
        const int v = s < nst ? sp[s] : span_pack(kEmpty, -1);
        const bool on = span_lo(v) <= span_hi(v);
        const unsigned m = __ballot_sync(0xffffffffu, on);
        if (on) act[n + __popc(m & ((1u << lane) - 1))] = s;
        n += __popc(m);
        if (on) {
          ulo = min(ulo, span_lo(v));
          uhi = max(uhi, span_hi(v));
        }
      }
      ulo = (int)__reduce_min_sync(0xffffffffu, (unsigned)ulo);
      uhi = __reduce_max_sync(0xffffffffu, uhi);
      if (lane == 0) {
        act[kMaxStages] = n;
        act[kMaxStages + 1] = span_pack(ulo, uhi);
      }
    }
    __syncthreads();
  }

  // the msgs rows of stage s into slot ("full": rows of other blocks zero-filled, not read)
  __device__ void load(int s, int slot) {
    constexpr int EV = 16 / sizeof(T), VPR = FT / EV;  // elements a vector, vectors a row
    const long long row0 = stage_row(s);
    const T* msgs = static_cast<const T*>(a.msgs);
    T* dst = ms + (size_t)slot * kSR * LDC;
    for (int i = threadIdx.x; i < kSR * VPR; i += kThreads) {
      const int r = i / VPR, v = i % VPR;
      bool ok = row0 + r < a.nrows;
      if (a.mode == FULL) {
        const int rel = rid[s * kSR + r];
        ok = ok && rel >= 0 && rel < S_BLK;
      }
      cp16z(dst + r * LDC + v * EV, msgs + (ok ? row0 + r : 0) * a.F + col0 + v * EV, ok);
    }
  }

  // the one-hot's rows of the span, columns [k0, k0 + N) of stage s, in
  // shared memory: a thread 16 bytes (8 bf16 or 4 f32 entries) at a time
  template <int N>
  __device__ void build_oh(int s, int span, int k0) {
    constexpr int EV = 16 / sizeof(T), G = N / EV;  // entries a store, stores a row
    const int r0 = span_lo(span) * 16, nr = (span_hi(span) + 1) * 16 - r0;
    const int* ids = rid + s * kSR + k0;
    for (int i = threadIdx.x; i < nr * G; i += kThreads) {
      const int r = r0 + i / G, k = (i % G) * EV;
      uint4 v;
      uint32_t* w = reinterpret_cast<uint32_t*>(&v);
      const int4 i0 = *reinterpret_cast<const int4*>(ids + k);
      if constexpr (EV == 8) {
        const int4 i1 = *reinterpret_cast<const int4*>(ids + k + 4);
        w[0] = oh2(i0.x == r, i0.y == r);
        w[1] = oh2(i0.z == r, i0.w == r);
        w[2] = oh2(i1.x == r, i1.y == r);
        w[3] = oh2(i1.z == r, i1.w == r);
      } else {
        w[0] = oh1(i0.x == r);
        w[1] = oh1(i0.y == r);
        w[2] = oh1(i0.z == r);
        w[3] = oh1(i0.w == r);
      }
      *reinterpret_cast<uint4*>(oh + r * LDA + k0 + k) = v;
    }
  }

  // the B fragments of k rows [kb, kb + K) of the staged msgs tile m: bf16
  // by ldmatrix.trans; f32 as TF32 hi and lo parts
  __device__ void frag_b(uint32_t (&bh)[NT][2], uint32_t (&bl)[NT][2], const T* m, int kb) const {
    if constexpr (K == 16) {
      const int row = kb + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        const int n0 = (wn * NT + nt) * 8;
        if constexpr (NT == 1) {
          ldsm_x2_t(bh[nt], m + row * LDC + n0);
        } else {
          uint32_t r[4];
          ldsm_x4_t(r, m + row * LDC + n0 + (lane >> 4) * 8);
          bh[nt][0] = r[0];
          bh[nt][1] = r[1];
          bh[nt + 1][0] = r[2];
          bh[nt + 1][1] = r[3];
        }
      }
    } else {
      const float* f = reinterpret_cast<const float*>(m);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = (wn * NT + nt) * 8 + g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x = f[(kb + t + 4 * h) * LDC + n];
          bh[nt][h] = tf32(x);
          bl[nt][h] = tf32(__fsub_rn(x, __uint_as_float(bh[nt][h])));
        }
      }
    }
  }

  // the one-hot's A fragment of owned m-tile mt, k rows [kb, kb + K) of
  // stage s: from the ids (build C, noonehot) or the one-hot in shared memory
  __device__ void frag_a(uint32_t (&af)[4], int mt, int s, int kb) const {
    const int s0 = seg0(mt) + g, s1 = s0 + 8;
    if (a.mode == NOONEHOT || a.build == BUILD_C) {
      const int* ids = rid + s * kSR;
      const int rc0 = chunk_row(s);
      auto id = [&](int k) { return a.mode == NOONEHOT ? (rc0 + k) % S_BLK : ids[k]; };
      if constexpr (K == 16) {  // k 2t, 2t+1 and 2t+8, 2t+9
        const int r0 = id(kb + 2 * t), r1 = id(kb + 2 * t + 1);
        const int r2 = id(kb + 2 * t + 8), r3 = id(kb + 2 * t + 9);
        af[0] = oh2(r0 == s0, r1 == s0);
        af[1] = oh2(r0 == s1, r1 == s1);
        af[2] = oh2(r2 == s0, r3 == s0);
        af[3] = oh2(r2 == s1, r3 == s1);
      } else {  // k t and t+4
        const int r0 = id(kb + t), r1 = id(kb + t + 4);
        af[0] = oh1(r0 == s0);
        af[1] = oh1(r0 == s1);
        af[2] = oh1(r1 == s0);
        af[3] = oh1(r1 == s1);
      }
    } else if constexpr (K == 16) {  // rows of the m-tile, k halves: ldmatrix
      ldsm_x4(af, oh + (seg0(mt) + (lane & 7) + ((lane >> 3) & 1) * 8) * LDA + kb +
                      (lane >> 4) * 8);
    } else {
      const int k0 = kb + t, k1 = k0 + 4;
      af[0] = *reinterpret_cast<const uint32_t*>(oh + s0 * LDA + k0);
      af[1] = *reinterpret_cast<const uint32_t*>(oh + s1 * LDA + k0);
      af[2] = *reinterpret_cast<const uint32_t*>(oh + s0 * LDA + k1);
      af[3] = *reinterpret_cast<const uint32_t*>(oh + s1 * LDA + k1);
    }
  }

  // d[nt] += af x b[nt]: one bf16 product, or the two TF32 products (the
  // low part first)
  __device__ static void mma_tile(float (&d)[NT][4], const uint32_t (&af)[4],
                                  const uint32_t (&bh)[NT][2], const uint32_t (&bl)[NT][2]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if constexpr (K == 8) mma(d[nt], af, bl[nt], T());
      mma(d[nt], af, bh[nt], T());
    }
  }

  // the products of stage s into acc: one-hot^T [S_BLK, 64] x msgs [64, FT],
  // on the owned m-tiles inside the stage's span; each m-tile's 64 rows are
  // summed from zero by the tensor cores and then added to acc in f32
  __device__ void products(float (&acc)[MT][NT][4], int s, int slot, int span) {
    const T* m = ms + (size_t)slot * kSR * LDC;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (!owned_active(mt, span)) continue;
      float d[NT][4] = {};
#pragma unroll
      for (int kb = 0; kb < kSR; kb += K) {
        uint32_t bh[NT][2], bl[NT][2], af[4];
        frag_b(bh, bl, m, kb);
        frag_a(af, mt, s, kb);
        mma_tile(d, af, bh, bl);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += d[nt][e];
    }
  }

  // build B: the one-hot written one k-slice at a time, two barriers a
  // slice, so the slices run outermost; each slice's product from zero
  __device__ void products_sliced(float (&acc)[MT][NT][4], int s, int slot, int span) {
    const T* m = ms + (size_t)slot * kSR * LDC;
    bool any = false;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) any |= owned_active(mt, span);
    for (int kb = 0; kb < kSR; kb += K) {
      build_oh<K>(s, span, kb);
      __syncthreads();
      if (any) {
        uint32_t bh[NT][2], bl[NT][2];
        frag_b(bh, bl, m, kb);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (!owned_active(mt, span)) continue;
          uint32_t af[4];
          frag_a(af, mt, s, kb);
          float d[NT][4] = {};
          mma_tile(d, af, bh, bl);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += d[nt][e];
        }
      }
      __syncthreads();
    }
  }

  // nomatmul / dmaonly: acc[s] += msgs[off + s] (+ the one-hot's column 0)
  __device__ void surrogate(float (&acc)[MT][NT][4], int st, int slot) {
    const int s_lo = chunk_row(st);
    if (s_lo >= S_BLK) return;
    const T* m = ms + (size_t)slot * kSR * LDC;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = seg0(mt) + g + 8 * (e >> 1), r = s - s_lo;
        if (r < 0 || r >= kSR) continue;
        const float ind = a.mode == NOMATMUL && rid[st * kSR + r] == 0 ? 1.f : 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float x = to_f(m[r * LDC + (wn * NT + nt) * 8 + 2 * t + (e & 1)]);
          acc[mt][nt][e] += a.mode == NOMATMUL ? x + ind : x;
        }
      }
  }

  __device__ void stage(float (&acc)[MT][NT][4], int s, int slot) {
    if (a.mode == FULL || a.mode == NOONEHOT) {
      const int span = sp[s];
      if (a.mode == FULL && a.build == BUILD_B) {
        products_sliced(acc, s, slot, span);
        return;
      }
      if (a.mode == FULL && a.build == BUILD_A) {
        build_oh<kSR>(s, span, 0);
        __syncthreads();
      }
      products(acc, s, slot, span);
    } else {
      surrogate(acc, s, slot);
    }
  }

  __device__ void run(const Item& it, int tile) {
    ct = tile;
    col0 = tile * FT;
    b = it.b;
    base = b * S_BLK;
    long long start_al;
    const int nch = window_chunks(a.bip, b, a.nrows, a.chunk, &start_al);
    const int c_lo = it.j * a.cpi, c_hi = min(c_lo + a.cpi, nch);
    row_first = start_al + (long long)c_lo * a.chunk;
    const int nrow_item = c_hi > c_lo ? (c_hi - c_lo) * a.chunk : 0;
    const int spc = a.chunk / kSR;
    __syncthreads();  // the previous item's reads of shared memory are done
    plan_stages(nrow_item);
    const int nact = act[kMaxStages], uspan = act[kMaxStages + 1];
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
      if (i < nact) load(act[i], i);
      cp_commit();
    }
    for (int q = 0; q < nact; ++q) {
      cp_wait_stage(a.nbuf);
      __syncthreads();  // stage q landed for all; stage q - 1's reads are done
      if (q + a.nbuf - 1 < nact) load(act[q + a.nbuf - 1], (q + a.nbuf - 1) % a.nbuf);
      cp_commit();
      const int s = act[q];
      const int set = (c_lo + s / spc) % NACC;  // the chunk counted from the block's start_al
#pragma unroll
      for (int i = 0; i < NACC; ++i)
        if (i == set) stage(acc[i], s, q % a.nbuf);
    }
    // the item's sum of its sets, in set order: to out, or to its partial
    const bool alone = it.slot == -1;
    if (it.slot == -2) return;  // no room for the partial (block_indptr out of order)
    float* dst = alone ? a.out + (size_t)base * a.F : a.part + (size_t)(it.slot + it.j) * S_BLK * a.F;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (!alone && !owned_active(mt, uspan)) continue;
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
          const int s = seg0(mt) + g + 8 * h;
          const int col = col0 + (wn * NT + nt) * 8 + 2 * t;
          *reinterpret_cast<float2*>(dst + (size_t)s * a.F + col) = make_float2(v0, v1);
        }
    }
    if (!alone && threadIdx.x == 0) a.spans[(size_t)(it.slot + it.j) * ncol + ct] = uspan;
  }
};

template <typename T, int MT, int NACC>
__global__ void __launch_bounds__(kThreads, Cfg<T, MT, NACC>::MIN_BLOCKS)
    segsum_onehot_kernel(Args args, int item_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  Block<T, MT, NACC> blk(args, smem, item_rows);
  // (item, column tile) units, the tile fastest: an item's tiles run side by
  // side and read the same rows' lines together
  const int ncol = args.F / Cfg<T, MT, NACC>::FT;
  const long long units = (long long)*args.total * ncol;
  for (long long u = blockIdx.x; u < units; u += gridDim.x)
    blk.run(args.items[u / ncol], (int)(u % ncol));
}

// the second pass: out rows of a split block = its items' partials added
// in item order, each item only where its span reached. A unit is (split
// block, m-tile, column tile): the items reaching the m-tile are listed
// in order in shared memory, then read 8 at a time (one float4 a thread)
template <int S_BLK, int FT>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const int* __restrict__ hdr, const Item* __restrict__ splits,
                   const int* __restrict__ spans, const float* __restrict__ part,
                   float* __restrict__ out, int F, int ncol) {
  constexpr int MTT = S_BLK / 16, V4 = FT / 4, U = 8, W = kThreads / 32;
  __shared__ int list[kThreads];
  __shared__ int wcount[W];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int units = hdr[1] * MTT * ncol;
  const bool mine = threadIdx.x < 16 * V4;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int k = u / (MTT * ncol), mt = u / ncol % MTT, ct = u % ncol;
    const Item sb = splits[k];
    if (sb.slot < 0) continue;  // no room for its partials (block_indptr out of order)
    const int row = mt * 16 + threadIdx.x / V4, c = ct * FT + threadIdx.x % V4 * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < sb.nitems; j0 += kThreads) {
      const int j = j0 + threadIdx.x;
      bool on = false;
      if (j < sb.nitems) {
        const int sv = spans[(size_t)(sb.slot + j) * ncol + ct];
        on = mt >= span_lo(sv) && mt <= span_hi(sv);
      }
      const unsigned m = __ballot_sync(0xffffffffu, on);
      if (lane == 0) wcount[w] = __popc(m);
      __syncthreads();
      int off = 0, n = 0;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        off += i < w ? wcount[i] : 0;
        n += wcount[i];
      }
      if (on) list[off + __popc(m & ((1u << lane) - 1))] = j;
      __syncthreads();
      if (mine) {
        for (int i0 = 0; i0 < n; i0 += U) {
          float4 x[U];
#pragma unroll
          for (int i = 0; i < U; ++i)
            x[i] = i0 + i < n ? *reinterpret_cast<const float4*>(
                                    part + ((size_t)(sb.slot + list[i0 + i]) * S_BLK + row) * F + c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int i = 0; i < U; ++i)
            if (i0 + i < n) {
              v.x += x[i].x;
              v.y += x[i].y;
              v.z += x[i].z;
              v.w += x[i].w;
            }
        }
      }
      __syncthreads();  // list and wcount are reused
    }
    if (mine) *reinterpret_cast<float4*>(out + ((size_t)sb.b * S_BLK + row) * F + c) = v;
  }
}

template <typename T, int MT, int NACC>
int launch(Args args, int num_blocks, int cap, int slots_cap, int* ws, cudaStream_t s) {
  using C = Cfg<T, MT, NACC>;
  if (args.F % C::FT) return (int)cudaErrorInvalidValue;
  const int ncol = args.F / C::FT, item_rows = args.cpi * args.chunk;
  const size_t bytes = (size_t)args.nbuf * kSR * C::LDC * sizeof(T) +
                       ((size_t)item_rows + 2 * kMaxStages + 4) * 4 +
                       (args.mode == FULL && args.build != BUILD_C
                            ? (size_t)C::S_BLK * C::LDA * sizeof(T)
                            : 0);
  cudaError_t e = cudaFuncSetAttribute(segsum_onehot_kernel<T, MT, NACC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (num_blocks <= 0) return (int)cudaGetLastError();
  // ws: [items, split blocks, pad x 2][cap items][num_blocks splits][slots_cap x ncol spans]
  int* hdr = ws;
  Item* items = reinterpret_cast<Item*>(ws + 4);
  Item* splits = items + cap;
  args.total = hdr;
  args.items = items;
  args.spans = reinterpret_cast<int*>(splits + num_blocks);
  plan_kernel<<<1, kPlanThreads, 0, s>>>(args.bip, num_blocks, args.nrows, args.chunk, args.cpi,
                                         cap, slots_cap, hdr, items, splits);
  segsum_onehot_kernel<T, MT, NACC>
      <<<(unsigned)((long long)cap * ncol), kThreads, bytes, s>>>(args, item_rows);
  combine_kernel<C::S_BLK, C::FT><<<kCombineBlocks, kThreads, 0, s>>>(
      hdr, splits, args.spans, args.part, args.out, args.F, ncol);
  return (int)cudaGetLastError();
}

template <typename T, int MT>
int launch_nacc(const Args& args, int nacc, int nb, int cap, int slots, int* ws, cudaStream_t s) {
  if (nacc == 1) return launch<T, MT, 1>(args, nb, cap, slots, ws, s);
  if (nacc == 2) return launch<T, MT, 2>(args, nb, cap, slots, ws, s);
  if (nacc == 4) return launch<T, MT, 4>(args, nb, cap, slots, ws, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_sblk(const Args& args, int s_blk, int nacc, int nb, int cap, int slots, int* ws,
                cudaStream_t s) {
  if (s_blk == 64) return launch_nacc<T, 1>(args, nacc, nb, cap, slots, ws, s);
  if (s_blk == 128) return launch_nacc<T, 2>(args, nacc, nb, cap, slots, ws, s);
  if (s_blk == 256) return launch_nacc<T, 4>(args, nacc, nb, cap, slots, ws, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// msgs [nrows, F] (dtype 0 = f32, 1 = bf16), dst [nrows] int32, block_indptr
// [num_blocks + 1] int32 (non-decreasing, within [0, nrows]), out
// [num_blocks * s_blk, F] f32. s_blk in {64, 128, 256}, nacc in {1, 2, 4},
// nbuf in {2, 3, 4, 6}, chunk a multiple of 64, F a multiple of 64; mode and
// build as the enums above; load_ids 0 for the modes that copy no ids. cpi:
// chunks a work item (cpi * chunk <= 4096); cap: the grid, at least the
// items (num_blocks + cdiv(nrows + 128 num_blocks, cpi chunk) is); ws
// int32 workspace of 4 + 4 cap + 4 num_blocks + slots_cap * F / 16
// entries (a tile FT holds at least 16 columns); part [slots_cap, s_blk, F] f32, slots_cap at least the items of
// split blocks (cuda_onehot.slots_bound). Three launches: the plan, the
// items, the second pass. Returns cudaGetLastError().
int allset_segsum_onehot(const void* msgs, const void* dst, const void* block_indptr,
                         long long nrows, int num_blocks, int F, int s_blk, int chunk, int nbuf,
                         int nacc, int mode, int build, int load_ids, int cpi, int cap,
                         int slots_cap, void* ws, void* part, void* out, int dtype,
                         void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (chunk <= 0 || chunk % kSR || F <= 0 || F % 64 || mode < FULL || mode > DMAONLY ||
      build < BUILD_A || build > BUILD_C || (nbuf != 2 && nbuf != 3 && nbuf != 4 && nbuf != 6) ||
      cpi <= 0 || (long long)cpi * chunk > kMaxItemRows || cap < num_blocks || slots_cap < 0)
    return (int)cudaErrorInvalidValue;
  const Args args{msgs, static_cast<const int*>(dst), static_cast<const int*>(block_indptr),
                  nrows, F, chunk, nbuf, mode, build, load_ids, cpi, nullptr, nullptr, nullptr,
                  static_cast<float*>(part), static_cast<float*>(out)};
  int* w = static_cast<int*>(ws);
  if (dtype == 0) return launch_sblk<float>(args, s_blk, nacc, num_blocks, cap, slots_cap, w, s);
  return launch_sblk<__nv_bfloat16>(args, s_blk, nacc, num_blocks, cap, slots_cap, w, s);
}

}  // extern "C"
