"""Time K3 (the PMA epilogue's backward) and its parts on one card.

    python3 scripts/k3_parts.py [OTHER_TREE] [--pairs N] [--hc 384,512]
    python3 scripts/k3_parts.py --phases [--hc 384,512]

Alone, a worker measures this tree. With OTHER_TREE (another checkout,
for example the parent commit unpacked with ``git archive`` into an
ignored directory), workers run in the order other, this, this, other
for each pair, so that drift on the card falls on both sides. A worker
imports its own tree's package and ``chip_smoke.py`` (the package never
imports either), builds its kernels once per tree and, on the card,
measures with CUDA events:

  * K3 per bench step: bf16, 8 heads, rFF L = 2, the two half-layers'
    rows (196,608 and 131,072), at HC 64, 128, 192, 256, 384 and 512;
  * K3R per 20-run epoch: f32, 8 heads, L = 2, R = 20 on the walmart
    preset's rows (158,766 and 88,860), at HC 128, 256, 384 and 512

(``--hc`` keeps only the listed widths of both lists), each as the whole launch and, where the tree has ``cuda_pma._bwd_setup``,
as its parts K3a (the row pass), K3b (the dW partials) and K3c (the two
reduces), with the bound of ``chip_smoke.epi_cost``. It prints the
ptxas registers and spills of the K3 kernels and one JSON line; the
script prints, per tree, the mean, lowest and highest reading of each
number, with the card's name and power limit.

``--phases`` splits the cluster K3a (HC 384 and 512) instead: it builds
``csrc/pma_epilogue_cluster_bwd.cu`` with ``-DCB_PHASES`` into a library
of its own in a temporary directory (thread 0 of each block stamps
``clock64()`` at the ends of the phases in PHASES; the package's build is
not touched), launches its K3a at the same shapes and prints the stamped
K3a's time and each phase's share of the clocks summed over the blocks
(a phase includes the waits at the barriers that end it). Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

BENCH_ROWS = (196_608, 131_072)
WALMART_ROWS = (158_766, 88_860)
PHASES = ("agg rows landing", "LN0 and its statistics", "zb exchange", "forward products",
          "h1 exchange", "gy staged, LN1 and its statistics", "LN1 backward",
          "dp exchange", "dp @ W^T products", "LN0 backward", "dagg and dden")


def phases(widths) -> None:
    """The cluster K3a's phase split (see the module note) at ``widths``."""
    import ctypes
    import tempfile

    import torch

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    import chip_smoke as cs
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "libk3phases.so")
        src = os.path.join(here, "allset_tpu_torch", "csrc", "pma_epilogue_cluster_bwd.cu")
        r = subprocess.run([_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
                            "-v", "-DCB_PHASES", "-o", so, src], capture_output=True, text=True)
        if r.returncode:
            print(r.stderr[-6000:])
            raise SystemExit("the stamped build failed")
        for name, regs, st, ld in cs.ptxas_summary(r.stderr):
            if "pma_bwd_cluster_kernel" in name:
                print(f"ptxas (stamped) {name}: {regs} registers, spill stores {st} B, "
                      f"spill loads {ld} B", flush=True)
        lib = ctypes.CDLL(so)
        entry = "allset_pma_epilogue_bwd_cluster"

        class Stamped:  # the package's entry, from the stamped library
            def __getattr__(self, name):
                if name == "allset_error_string":
                    return lambda rc: b"(stamped build)"
                if name != entry:
                    raise AttributeError(name)
                fn = getattr(lib, entry)
                fn.argtypes = _kernels._SIGNATURES[entry]
                fn.restype = ctypes.c_int
                return fn
        _kernels.lib = Stamped
        lib.allset_cb_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
        dev = torch.device("cuda", 0)
        gen = torch.Generator().manual_seed(0)
        H, L = 8, 2
        cases = [(HC, "bench step", M, None, torch.bfloat16) for HC in sorted(widths)
                 for M in BENCH_ROWS]
        cases += [(HC, "20-run epoch", M, 20, torch.float32) for HC in sorted(widths)
                  for M in WALMART_ROWS]
        for HC, label, M, R, dt in cases:
            if R is None:
                agg, gy, p = cs.epi_inputs(M, HC, H, HC + 8, L, dt, dev, gen, floor_rows=False)
            else:
                agg, gy, p = cs.runs_inputs(M, HC, H, HC + 8, L, R, dt, dev, gen,
                                            floor_rows=False)
            call, _ = cp._bwd_setup(agg, gy, *p, H, True, R)
            ms = cs.cuda_ms(lambda: call(1), 10 if R is None else 3)
            lib.allset_cb_phases(None, 1)
            call(1)
            torch.cuda.synchronize()
            tot = (ctypes.c_ulonglong * 12)()
            lib.allset_cb_phases(ctypes.addressof(tot), 0)
            cycles = sum(tot[:11])
            print(f"HC {HC}, {label}, M={M}, R={R or 1}, {str(dt)[6:]}: stamped K3a {ms:.4f} "
                  f"ms, {tot[11]} tile-blocks; " + ", ".join(
                      f"{nm} {100 * tot[i] / cycles:.1f}% ({ms * tot[i] / cycles:.4f} ms)"
                      for i, nm in enumerate(PHASES)), flush=True)
            del call, agg, gy, p
            torch.cuda.empty_cache()


def worker(widths=None) -> None:
    """Measure the tree in the working directory (see the module note) at
    ``widths`` (all of both lists when None)."""
    tree = os.getcwd()
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from allset_tpu_torch.ops import _kernels, cuda_pma as cp

    dev = torch.device("cuda", 0)
    log = os.path.join(_kernels.BUILD_DIR, "ptxas.log")
    fresh = not os.path.exists(log)
    _kernels.build(force=fresh)
    _kernels.lib()
    if fresh:
        with open(log, "w") as f:
            f.write(_kernels.build_log)
    with open(log) as f:
        for name, regs, st, ld in cs.ptxas_summary(f.read()):
            if "bwd" in name or "dw_" in name or "partial" in name:
                print(f"ptxas {name}: {regs} registers, spill stores {st} B, spill loads "
                      f"{ld} B", flush=True)
    gen = torch.Generator().manual_seed(0)
    H, L = 8, 2
    out = {"tree": tree}
    cases = [(HC, "step", BENCH_ROWS, None, torch.bfloat16)
             for HC in (64, 128, 192, 256, 384, 512)]
    cases += [(HC, "epoch", WALMART_ROWS, 20, torch.float32) for HC in (128, 256, 384, 512)]
    cases = [c for c in cases if widths is None or c[0] in widths]
    for HC, label, rows, R, dt in cases:
        WP = HC + 8
        key = f"k3_{label}_hc{HC}"
        tot = {"all": 0.0, "a": 0.0, "b": 0.0, "c": 0.0, "bound": 0.0}
        for M in rows:
            if R is None:
                agg, gy, p = cs.epi_inputs(M, HC, H, WP, L, dt, dev, gen,
                                           floor_rows=False)
                whole = lambda: cp.epilogue_bwd_cuda(agg, gy, *p, H, True)
            else:
                agg, gy, p = cs.runs_inputs(M, HC, H, WP, L, R, dt, dev, gen,
                                            floor_rows=False)
                whole = lambda: cp.epilogue_bwd_runs_cuda(agg, gy, *p, H, True)
            iters = 10 if R is None else 3
            tot["all"] += cs.cuda_ms(whole, iters)
            if hasattr(cp, "_bwd_setup"):
                call, _ = cp._bwd_setup(agg, gy, *p, H, True, R)
                call()
                for part, bit in (("a", 1), ("b", 2), ("c", 4)):
                    tot[part] += cs.cuda_ms(lambda: call(bit), iters)
                del call
            nbytes, ops = cs.epi_cost(M, HC, WP, L, dt, True, R or 1)
            tot["bound"] += max(nbytes / cs.HBM,
                                sum(f / cs.PEAK[k] for f, k in ops)) * 1e3
            del agg, gy, p
            torch.cuda.empty_cache()
        for k, v in tot.items():
            if k == "all" or k == "bound" or hasattr(cp, "_bwd_setup"):
                out[f"{key}_{k}"] = v
        print(f"{key}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in tot.items()), flush=True)
    print("K3 " + json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="another checkout of the repository")
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--hc", help="comma-separated widths to keep (default: all)")
    ap.add_argument("--phases", action="store_true",
                    help="split the cluster K3a into its phases (HC 384 and 512)")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.phases:
        phases({int(x) for x in (args.hc or "384,512").split(",")})
        return 0
    order = [here] if args.other is None else [os.path.abspath(args.other), here, here,
                                                os.path.abspath(args.other)] * args.pairs
    script = os.path.abspath(__file__)
    rows = []
    for tree in order:
        extra = ["--hc", args.hc] if args.hc else []
        r = subprocess.run([sys.executable, script, "--worker", *extra], cwd=tree,
                           capture_output=True, text=True)
        print(r.stdout, flush=True)
        lines = [x for x in r.stdout.splitlines() if x.startswith("K3 ")]
        if r.returncode != 0 or not lines:
            print(r.stderr[-4000:])
            raise SystemExit(f"worker in {tree} failed ({r.returncode})")
        rows.append(json.loads(lines[-1][3:]))
    for tree in dict.fromkeys(order):
        mine = [r for r in rows if r["tree"] == tree]
        keys = [k for k in mine[0] if k != "tree"]
        means = {k: [sum(r[k] for r in mine) / len(mine), min(r[k] for r in mine),
                     max(r[k] for r in mine)] for k in keys}
        print(f"MEAN {tree} ({len(mine)} workers; mean, lowest, highest) [{card}]: "
              + json.dumps(means), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.path.pop(0)  # this file's directory; the worker imports its own tree
        hc = sys.argv[3] if sys.argv[2:3] == ["--hc"] else None
        worker(None if hc is None else {int(x) for x in hc.split(",")})
    else:
        sys.exit(main())
