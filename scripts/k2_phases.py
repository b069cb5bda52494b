"""Split K2 (the PMA epilogue's forward) into its phases on one card: the
tiled K2 (csrc/pma_epilogue_fwd.cu) or the cluster K2 at HC 384 and 512
(csrc/pma_epilogue_cluster.cu).

    python3 scripts/k2_phases.py [--hc 256|384|512] [--tree TREE] [--kernel tiled|cluster]

The script writes a copy of ``csrc/pma_epilogue_fwd.cu`` and
``csrc/pma_epilogue.cuh`` of TREE (this checkout by default; another one,
e.g. an earlier commit unpacked with ``git archive``, to split its K2)
into a temporary directory with ``clock64()`` stamps inserted at fixed
lines (thread 0 of each block adds the cycles since its last stamp to a
counter in shared memory), builds it with nvcc as a library of its own,
and launches its K2 at the main path's shapes at width HC (8 heads, L =
2):

  * the bench step's two half-layers (bf16, 196,608 and 131,072 rows);
  * the 20-run epoch's two half-layers (f32, R = 20, the walmart preset's
    158,766 and 88,860 rows).

The copy instantiates the tiled K2 at HC in both dtypes where the source
does not (the package routes f32 at 256 to the warpgroup K2 and 384 and
512 to the cluster K2).

Phases per tile of the tiled K2: the agg rows landing (the next tile's
copies started and the wait), LN0, product 0, bias/relu/round with the
next A operand, product 1, LN1 (with the last bias), the store. Of the
cluster K2 (``--kernel cluster``; its sources ``pma_wgmma.cuh`` and
``pma_epilogue_cluster.cu``), per tile and block: the rows landing, LN0
with its statistics across the pair, zb into both A buffers, the
products (less the two next), round(relu(p0)) into both A buffers, LN1
with the store, the waits for weight slabs and (f32) the slab barriers.
Thread 0's clock, so a phase includes its waits at the barriers that end
it. For each shape it prints
the stamped kernel's time (CUDA events) and the share of each phase
summed over the blocks' thread 0 (the stamps cost about 1% of the
kernel's time); and the stamped build's ptxas registers and spills of
each K2 instantiation and the card's name and power limit. Needs one CUDA
card; the package's own build is not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("agg rows landing", "LN0", "product 0", "bias/relu/round", "product 1", "LN1",
         "store")
CL_NAMES = ("rows landing", "LN0 and its statistics", "zb exchange", "products",
            "h1 exchange", "LN1 and store", "weight slab waits", "slab barriers")

STAMPS = """
__shared__ long long k2_acc[8];
__shared__ long long k2_last;
__device__ unsigned long long k2_total[8];
#define STAMP(k)                                    \\
  if (threadIdx.x == 0) {                           \\
    const long long now = clock64();                \\
    k2_acc[k] += now - k2_last;                     \\
    k2_last = now;                                  \\
  }
"""


def insert(text: str, anchor: str, new: str, count: int = 1) -> str:
    """text with ``new`` after each of the ``count`` occurrences of anchor."""
    if text.count(anchor) != count:
        raise SystemExit(f"stamp anchor found {text.count(anchor)} times, not {count}: "
                         f"{anchor[:60]!r}")
    return text.replace(anchor, anchor + new)


def stamped_sources(tmp: str, csrc: str, HC: int) -> str:
    """Write the stamped header and K2 source of csrc into tmp, with the
    tiled K2 instantiated at HC in both dtypes; return the source."""
    with open(os.path.join(csrc, "pma_epilogue.cuh")) as f:
        cuh = f.read()
    cuh = insert(cuh, "namespace {\n", STAMPS)
    chain = cuh.index("__device__ __forceinline__ void fwd_chain(")
    head, body = cuh[:chain], cuh[chain:]
    body = insert(body, "  put_a<T, HC, NT>(X, sA, n0, ln);\n  __syncthreads();\n", "  STAMP(1);\n")
    body = insert(body, "    rff_product<T, HC, NT, KS_F>(A, l, sA, sB, n0, ln, P);\n",
                  "    STAMP(l == 0 ? 2 : 4);\n")
    body = insert(body, "      put_a<T, HC, NT>(P, sA, n0, ln);\n      __syncthreads();\n",
                  "      STAMP(3);\n")
    end = "__fmul_rn(__fsub_rn(X[m][j][2 * h + q], mu), rstd);\n    }\n"
    body = insert(body, end, "  STAMP(5);\n")
    with open(os.path.join(tmp, "pma_epilogue.cuh"), "w") as f:
        f.write(head + body)
    with open(os.path.join(csrc, "pma_epilogue_fwd.cu")) as f:
        cu = f.read()
    kernel = cu.index("pma_fwd_kernel(Args<T> A0, int R) {")
    head, body = cu[:kernel], cu[kernel:]
    body = insert(body, "  extern __shared__ __align__(128) char smem[];\n",
                  "  if (threadIdx.x == 0) {\n    for (int i = 0; i < 8; ++i) k2_acc[i] = 0;\n"
                  "    k2_last = clock64();\n  }\n")
    body = insert(body, "    mbar_wait(bar + b, (k >> 1) & 1);\n", "    STAMP(0);\n")
    store = ("    store_tile(A, row0, TM, sT, SW, HC, A.out, A.ldg);\n"
             "    __syncthreads();  // these reads before the buffer's next copies\n"
             "  }\n}\n")
    body = insert(body, store[:-len("  }\n}\n")],
                  "    STAMP(6);\n    if (threadIdx.x == 0) k2_acc[7] += 1;\n")
    tail = "    if (threadIdx.x == 0) k2_acc[7] += 1;\n  }\n"
    body = insert(body, tail, "  if (threadIdx.x == 0)\n    for (int i = 0; i < 8; ++i)\n"
                  "      atomicAdd(&k2_total[i], (unsigned long long)k2_acc[i]);\n")
    cu = head + body
    for t in ("float", "__nv_bfloat16"):  # the tiled K2 at HC in both dtypes
        if f"FWD({t}, {HC})" not in cu:
            cu = insert(cu, f"FWD({t}, 64)", f" FWD({t}, {HC})")
    cu += """
extern "C" int k2_stamps(void* out, int zero) {
  if (zero) {
    unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(k2_total, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, k2_total, sizeof(k2_total));
}
"""
    path = os.path.join(tmp, "k2_stamped.cu")
    with open(path, "w") as f:
        f.write(cu)
    return path


CL_STAMPS = """
__shared__ long long k2_acc[9];
__shared__ long long k2_last;
__device__ unsigned long long k2_total[9];
#define STAMP(k)                                    \\
  if (threadIdx.x == 0) {                           \\
    const long long now = clock64();                \\
    k2_acc[k] += now - k2_last;                     \\
    k2_last = now;                                  \\
  }
"""


def stamped_cluster(tmp: str, csrc: str) -> str:
    """Write the stamped cluster K2 (and its headers) of csrc into tmp;
    return the source. Counters: the CL_NAMES in order, then the tiles.
    The products' stamps go where the products are: pma_cluster.cuh where
    the tree has it, else (an older tree) pma_epilogue_cluster.cu."""
    texts = {}
    for name in ("pma_epilogue.cuh", "pma_wgmma.cuh", "pma_cluster.cuh",
                 "pma_epilogue_cluster.cu"):
        if os.path.exists(os.path.join(csrc, name)):
            with open(os.path.join(csrc, name)) as f:
                texts[name] = f.read()
    texts["pma_wgmma.cuh"] = insert(texts["pma_wgmma.cuh"], "namespace {\n", CL_STAMPS)
    prod = "pma_cluster.cuh" if "pma_cluster.cuh" in texts else "pma_epilogue_cluster.cu"
    text = texts[prod]
    wait = "    mbar_wait(&full[slot], (n / nst) & 1);\n"
    for after in ("    float4* hi", "    const uint32_t b = smem_u32"):
        text = insert(text, wait + after, "", 1)
        text = text.replace(wait + after, "    STAMP(3);\n" + wait + "    STAMP(6);\n" + after)
    barrier = "    __syncthreads();  // slab n + 1 split; every warpgroup done with slab n\n"
    text = insert(text, barrier, "    STAMP(7);\n").replace(barrier, "    STAMP(3);\n" + barrier, 1)
    texts[prod] = text
    for name, text in texts.items():
        if name.endswith(".cuh"):
            with open(os.path.join(tmp, name), "w") as f:
                f.write(text)
    cu = texts["pma_epilogue_cluster.cu"]
    k = cu.index("pma_fwd_cluster_kernel(ClArgs<T> A, int R) {")
    head, body = cu[:k], cu[k:]
    body = insert(body, "  extern __shared__ __align__(128) char smem[];\n",
                  "  if (threadIdx.x == 0) {\n    for (int i = 0; i < 9; ++i) k2_acc[i] = 0;\n"
                  "    k2_last = clock64();\n  }\n")
    body = insert(body, "    mbar_wait(staged, k & 1);\n", "    STAMP(0);\n")
    row_sum = next(c for c in ("    cl_row_sum<NWG>(pa, pb, red, blk, blk0, blk1, 0, ln);\n",
                               "    cl_row_sum<NWG>(pa, pb, red, blk, blk0, blk1, 0, ln, cluster);\n")
                   if c in body)
    body = insert(body, row_sum, "    STAMP(1);\n")
    body = insert(body, "__float2bfloat16_rn(X[j][2 * h + 1]));\n    }\n    cluster.sync();\n",
                  "    STAMP(2);\n")
    relu = "      if (l + 1 < A.L) {  // h_1 = relu(p_0), exact in T\n"
    body = insert(body, relu, "").replace(relu, "      STAMP(3);\n" + relu)
    body = insert(body, "        cl_put_a<T, LD>(P, sA, pA, n0, ln);\n        cluster.sync();\n",
                  "        STAMP(4);\n")
    end = "  }\n  cluster.sync();  // the peer may still read this block's row partials\n"
    body = insert(body, end, "").replace(
        end, "    STAMP(5);\n    if (threadIdx.x == 0) k2_acc[8] += 1;\n" + end +
        "  if (threadIdx.x == 0)\n    for (int i = 0; i < 9; ++i)\n"
        "      atomicAdd(&k2_total[i], (unsigned long long)k2_acc[i]);\n")
    cu = head + body + """
extern "C" int k2_stamps(void* out, int zero) {
  if (zero) {
    unsigned long long z[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(k2_total, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, k2_total, sizeof(k2_total));
}
"""
    path = os.path.join(tmp, "k2_cluster_stamped.cu")
    with open(path, "w") as f:
        f.write(cu)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hc", type=int, default=256, choices=(256, 384, 512))
    ap.add_argument("--tree", default=HERE, help="the checkout whose K2 is split")
    ap.add_argument("--kernel", default="tiled", choices=("tiled", "cluster"))
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    if not torch.cuda.is_available():
        print("k2_phases: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        csrc = os.path.join(args.tree, "allset_tpu_torch", "csrc")
        cluster = args.kernel == "cluster"
        if cluster and args.hc == 256:
            raise SystemExit("the cluster K2 takes HC 384 and 512")
        src = stamped_cluster(tmp, csrc) if cluster else stamped_sources(tmp, csrc, args.hc)
        so = os.path.join(tmp, "libk2stamped.so")
        r = subprocess.run([_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
                            "-v", "-o", so, src], capture_output=True, text=True)
        if r.returncode:
            print(r.stderr[-6000:])
            return 1
        for name, regs, st, ld in cs.ptxas_summary(r.stderr):
            if "pma_fwd_kernel" in name or "pma_fwd_cluster_kernel" in name:
                print(f"ptxas (stamped) {name}: {regs} registers, spill stores {st} B, "
                      f"spill loads {ld} B", flush=True)
        lib = ctypes.CDLL(so)
        if cluster:
            fwd = lib.allset_pma_epilogue_fwd_cluster
            fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        else:
            fwd = lib.allset_pma_epilogue_fwd
            fwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.k2_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        gen = torch.Generator().manual_seed(0)
        HC, H, L = args.hc, 8, 2
        WP = HC + 8
        cases = [("bench step", M, None, torch.bfloat16) for M in (196_608, 131_072)]
        cases += [("20-run epoch", M, 20, torch.float32) for M in (158_766, 88_860)]
        for label, M, R, dt in cases:
            if R is None:
                agg, _, p = cs.epi_inputs(M, HC, H, WP, L, dt, dev, gen, floor_rows=False)
            else:
                agg, _, p = cs.runs_inputs(M, HC, H, WP, L, R, dt, dev, gen, floor_rows=False)
            runs = R or 1
            seed, g0, b0, W, b, g1, b1 = p
            seed, g0, b0, b, g1, b1 = cp._f32(seed, g0, b0, b, g1, b1)
            out = torch.empty(M, runs * HC, dtype=dt, device=dev)
            head = (agg.data_ptr(), seed.data_ptr(), g0.data_ptr(), b0.data_ptr())
            tail = (b.data_ptr(), g1.data_ptr(), b1.data_ptr(), out.data_ptr(), M, WP, HC, H, L,
                    runs, 1, _kernels.dtype_code(agg), _kernels.stream_ptr(agg))
            if cluster:
                wts = (cp.cluster_fwd_weights(W, dt),)
                call = lambda: fwd(*head, wts[0].data_ptr(), *tail)
            else:
                wts = cp._weights(W, dt)
                call = lambda: fwd(*head, wts[0].data_ptr(), cp._ptr(wts[1]), *tail)
            ms = cs.cuda_ms(call, 10 if R is None else 3)
            lib.k2_stamps(None, 1)
            if call() != 0:
                raise SystemExit("the stamped K2 failed to launch")
            torch.cuda.synchronize()
            names = CL_NAMES if cluster else NAMES
            n = len(names)
            tot = (ctypes.c_ulonglong * (n + 1))()
            lib.k2_stamps(ctypes.addressof(tot), 0)
            cycles = sum(tot[:n])
            shares = [tot[i] / cycles for i in range(n)]
            print(f"{label}, M={M}, R={runs}, {str(dt)[6:]}: stamped K2 ({args.kernel}) "
                  f"{ms:.4f} ms, {tot[n]} {'tile-blocks' if cluster else 'tiles'}; " + ", ".join(
                      f"{nm} {100 * f:.1f}% ({ms * f:.4f} ms)" for nm, f in zip(names, shares)),
                  flush=True)
            del agg, p, out, wts
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
