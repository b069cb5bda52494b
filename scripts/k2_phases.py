"""Split the tiled K2 (the PMA epilogue's forward, csrc/pma_epilogue_fwd.cu)
into its phases on one card.

    python3 scripts/k2_phases.py

The script writes a copy of ``csrc/pma_epilogue_fwd.cu`` and
``csrc/pma_epilogue.cuh`` into a temporary directory with ``clock64()``
stamps inserted at fixed lines (thread 0 of each block adds the cycles
since its last stamp to a counter in shared memory), builds it with nvcc
as a library of its own, and launches its K2 at the main path's shapes:

  * the bench step's two half-layers (bf16, HC 256, 8 heads, L = 2,
    196,608 and 131,072 rows);
  * the 20-run epoch's two half-layers (f32, R = 20, the walmart preset's
    158,766 and 88,860 rows; the copy instantiates the tiled f32 K2 at HC 256,
    which the package no longer routes there).

Phases per tile: the agg rows landing (the next tile's copies started and
the wait), LN0, product 0, bias/relu/round with the next A operand,
product 1, LN1 (with the last bias), the store. For each shape it prints
the stamped kernel's time (CUDA events) and the share of each phase
summed over the blocks' thread 0 (the stamps cost about 1% of the
kernel's time); and the stamped build's ptxas registers and spills of
each K2 instantiation and the card's name and power limit. Needs one CUDA
card; the package's own build is not touched.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "allset_tpu_torch", "csrc")
NAMES = ("agg rows landing", "LN0", "product 0", "bias/relu/round", "product 1", "LN1",
         "store")

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


def stamped_sources(tmp: str) -> str:
    """Write the stamped header and K2 source into tmp; return the source."""
    with open(os.path.join(CSRC, "pma_epilogue.cuh")) as f:
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
    with open(os.path.join(CSRC, "pma_epilogue_fwd.cu")) as f:
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
    # the tiled f32 K2 at HC 256 (the package routes f32 there to the warpgroup K2)
    cu = re.sub(r"FWD\(float, 192\) FWD\(float, 384\)",
                "FWD(float, 192) FWD(float, 256) FWD(float, 384)", cu)
    if "FWD(float, 256)" not in cu:
        raise SystemExit("could not instantiate the f32 K2 at HC 256")
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


def main() -> int:
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
        src = stamped_sources(tmp)
        so = os.path.join(tmp, "libk2stamped.so")
        r = subprocess.run([_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
                            "-v", "-o", so, src], capture_output=True, text=True)
        if r.returncode:
            print(r.stderr[-6000:])
            return 1
        for name, regs, st, ld in cs.ptxas_summary(r.stderr):
            if "pma_fwd_kernel" in name:
                print(f"ptxas (stamped) {name}: {regs} registers, spill stores {st} B, "
                      f"spill loads {ld} B", flush=True)
        lib = ctypes.CDLL(so)
        fwd = lib.allset_pma_epilogue_fwd
        fwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.k2_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        gen = torch.Generator().manual_seed(0)
        HC, H, WP, L = 256, 8, 264, 2
        cases = [("bench step", M, None, torch.bfloat16) for M in (196_608, 131_072)]
        cases += [("20-run epoch", M, 20, torch.float32) for M in (158_766, 88_860)]
        for label, M, R, dt in cases:
            if R is None:
                agg, _, p = cs.epi_inputs(M, HC, H, WP, L, dt, dev, gen, floor_rows=False)
            else:
                agg, _, p = cs.runs_inputs(M, HC, H, WP, L, R, dt, dev, gen, floor_rows=False)
            runs = R or 1
            seed, g0, b0, W, b, g1, b1 = p
            Wf, Wbt = cp._weights(W, dt)
            seed, g0, b0, b, g1, b1 = cp._f32(seed, g0, b0, b, g1, b1)
            out = torch.empty(M, runs * HC, dtype=dt, device=dev)
            call = lambda: fwd(agg.data_ptr(), seed.data_ptr(), g0.data_ptr(), b0.data_ptr(),
                               Wf.data_ptr(), cp._ptr(Wbt), b.data_ptr(), g1.data_ptr(),
                               b1.data_ptr(), out.data_ptr(), M, WP, HC, H, L, runs, 1,
                               _kernels.dtype_code(agg), _kernels.stream_ptr(agg))
            ms = cs.cuda_ms(call, 10 if R is None else 3)
            lib.k2_stamps(None, 1)
            if call() != 0:
                raise SystemExit("the stamped K2 failed to launch")
            torch.cuda.synchronize()
            tot = (ctypes.c_ulonglong * 8)()
            lib.k2_stamps(ctypes.addressof(tot), 0)
            cycles = sum(tot[:7])
            shares = [tot[i] / cycles for i in range(7)]
            print(f"{label}, M={M}, R={runs}, {str(dt)[6:]}: stamped K2 {ms:.4f} ms, "
                  f"{tot[7]} tiles; " + ", ".join(
                      f"{n} {100 * f:.1f}% ({ms * f:.4f} ms)" for n, f in zip(NAMES, shares)),
                  flush=True)
            del agg, p, out, Wf, Wbt
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
