"""Time the gather inside K1 by L2 budget, probe the L2's read rate, and
time the gather inside K1 and K4 against another tree's kernels, on one
card.

    python3 scripts/gather_slabs.py [OTHER_TREE] [--pairs N] [--budgets 8,16,32]

* The L2 probe: the gather inside K1 on a 32 MiB table (bf16, 264
  columns) read as one slab by 3 million random ids in segments of 12,
  so that every gathered row after the first touch comes from L2. Its
  rate, the gathered bytes over the time, is the floor of a slab design:
  the gathered bytes of a pass over that rate.
* The sweep: the gather inside K1 on _Spmm's passes of the bench step
  (bf16, width 264; 4 passes) and of the walmart 20-run epoch (f32, 20 x
  264; 6 passes), summed, at each L2 budget (MiB) and as one slab (a
  budget above every table), with the slab count of each pass; every
  result bit for bit that of the default budget. Then per pass: the
  gather at the default budget beside K1 over the same chunk plan on a
  table read in order, which prices the plan's own share (its cut
  segments' second pass).
* With OTHER_TREE (another checkout, e.g. the parent unpacked with
  ``git archive`` into the ignored ``_verify/``): that tree's
  ``csrc/segment_sum.cu`` and ``csrc/pma_pack.cu`` are built alone with
  nvcc into a temporary directory and called through their C entries of
  PRs 10-12 (``allset_segment_sum_gather`` without the slab arguments,
  ``allset_pma_gmax`` on a zeroed gmax), on the same inputs as this
  tree's, in alternating order (other, this, this, other) for ``--pairs``
  pairs: the gather inside K1 per step and per epoch, and K4 per step and
  per epoch through its wrapper (the other tree's: torch.zeros and the
  call) and as a launch alone, beside torch.amax over the score columns.
  Each pair of results is checked bit for bit.

Prints the card's name and power limit, a line per measurement, then one
JSON line. Needs one CUDA card; about 3 minutes with the builds.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from allset_tpu_torch.experiments.exp_fused_gather import spmm_passes  # noqa: E402
from allset_tpu_torch.graph.incidence import chunk_plan  # noqa: E402
from allset_tpu_torch.ops import _kernels, cuda_pack as ck, cuda_segment as cseg  # noqa: E402

MiB = 1 << 20
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build_other(tree: str, tmp: str) -> ctypes.CDLL:
    """The other tree's segment_sum.cu and pma_pack.cu in one library."""
    srcs = [os.path.join(tree, "allset_tpu_torch", "csrc", f) for f in
            ("segment_sum.cu", "pma_pack.cu")]
    so = os.path.join(tmp, "libother.so")
    subprocess.run([_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so, *srcs], check=True)
    lib = ctypes.CDLL(so)
    lib.allset_segment_sum_gather.argtypes = [P, LL, P, I, P, I, I, I, P, P, I, P, I, P, P, I,
                                              I, P]
    lib.allset_pma_gmax.argtypes = [P] * 3 + [I] * 6 + [P]
    for f in (lib.allset_segment_sum_gather, lib.allset_pma_gmax):
        f.restype = ctypes.c_int
    return lib


def other_gather(lib, table, ids, ip, nseg, plan):
    W = table.shape[1]
    out = torch.empty(nseg, W, dtype=table.dtype, device=table.device)
    part = torch.empty(plan.num_partials, W, dtype=torch.float32, device=table.device)
    rc = lib.allset_segment_sum_gather(
        table.data_ptr(), table.shape[0], ids.data_ptr(), int(ids.dtype == torch.int64), None,
        ids.shape[0], W, 1, ip.data_ptr(), plan.chunks.data_ptr(), plan.chunks.shape[0],
        plan.cuts.data_ptr(), plan.cuts.shape[0], part.data_ptr(), out.data_ptr(), W,
        _kernels.dtype_code(table), _kernels.stream_ptr(table))
    _kernels.check(rc, "other tree's segment_sum_gather")
    return out


def other_gmax(lib, yf, ba, H, HC):
    R = yf.shape[1] if yf.dim() == 3 else 1
    gmax = torch.zeros(ba.shape, dtype=torch.float32, device=yf.device)
    rc = lib.allset_pma_gmax(yf.data_ptr(), ba.data_ptr(), gmax.data_ptr(), yf.shape[0], R,
                             yf.shape[-1], HC, H, _kernels.dtype_code(yf),
                             _kernels.stream_ptr(yf))
    _kernels.check(rc, "other tree's pma_gmax")
    return gmax


def l2_probe(dev):
    """(GB/s, ms) of the gather inside K1 on a 32 MiB table in one slab."""
    W, rows = 264, 32 * MiB // (264 * 2)
    k, seg = 3 << 20, 12
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(rows, W, generator=gen).to(torch.bfloat16).to(dev)
    ids = torch.randint(0, rows, (k,), generator=gen).to(dev)
    indptr = torch.arange(0, k + 1, seg, dtype=torch.int32)
    plan = chunk_plan(indptr.numpy()).to(dev)
    ip = indptr.to(dev)
    nseg = indptr.shape[0] - 1
    ms = cs.cuda_ms(lambda: cseg.gather_segment_sum_cuda(table, ids, ip, nseg, plan,
                                                          budget=1 << 40), iters=20)
    return k * W * 2 / (ms * 1e-3) / 1e9, ms


def sweep(passes, budgets):
    """{budget MiB or 'one slab': ms summed over the passes} and the slab
    counts at the default budget; each result bit for bit the default's."""
    out, slabs = {}, []
    for table, ids, ip, nseg, plan, n in passes:
        ref = cseg.gather_segment_sum_cuda(table, ids, ip, nseg, plan)
        slabs.append(cseg.slab_plan(table.shape[0], table.shape[1], table.element_size())[1])
        for b in budgets + [None]:
            budget = (1 << 40) if b is None else b * MiB
            got = cseg.gather_segment_sum_cuda(table, ids, ip, nseg, plan, budget=budget)
            if not torch.equal(got, ref):
                raise AssertionError(f"budget {b} MiB changes the bits")
            ms = cs.cuda_ms(lambda: cseg.gather_segment_sum_cuda(table, ids, ip, nseg, plan,
                                                                  budget=budget), iters=10)
            key = "one slab" if b is None else b
            out[key] = out.get(key, 0.0) + n * ms
    return out, slabs


def per_pass(passes):
    """Per pass, once each: [the gather inside K1 at the default budget,
    K1 over the same plan on a [k, W] table read in order (the plan's own
    cost: chunks, cut segments, the second pass), cut segments, the
    largest one's partial rows] in ms, ms, count, count."""
    out = []
    for table, ids, ip, nseg, plan, _ in passes:
        g = cs.cuda_ms(lambda: cseg.gather_segment_sum_cuda(table, ids, ip, nseg, plan))
        msgs = torch.randn(ids.shape[0], table.shape[1], device=table.device).to(table.dtype)
        k1 = cs.cuda_ms(lambda: cseg.segment_sum_cuda(msgs, ip, nseg, plan))
        del msgs
        cuts = plan.cuts.cpu()
        out.append([g, k1, int(cuts.shape[0]), int(cuts[:, 2].max()) if cuts.shape[0] else 0])
    return out


def alternate(pairs, sides):
    """{name: [readings]} of each side's fn, in the order other, this,
    this, other per pair."""
    got = {name: [] for name in sides}
    for _ in range(pairs):
        for name in ("other", "this", "this", "other"):
            got[name].append(sides[name]())
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="another checkout of the repository")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--budgets", default="8,16,24,32,40,48")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_slabs: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    _kernels.lib()  # builds unless the library is newer than every source
    res = {"card": card}
    res["l2_GBps"], res["l2_probe_ms"] = l2_probe(dev)
    print(f"L2 probe: {res['l2_GBps']:.1f} GB/s ({res['l2_probe_ms']:.4f} ms) [{card}]",
          flush=True)
    budgets = [int(b) for b in args.budgets.split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        other = build_other(os.path.abspath(args.other), tmp) if args.other else None
        for label, batch, W, dt, fwd, R in (
                ("step", cs.bench_batch(dev), 264, torch.bfloat16, 1, None),
                ("epoch", cs.walmart_batch(dev), 20 * 264, torch.float32, 2, 20)):
            passes = spmm_passes(batch, W, dt, fwd)
            res[f"sweep_{label}"], res[f"slabs_{label}"] = sweep(passes, budgets)
            res[f"passes_{label}"] = per_pass(passes)
            print(f"{label}: per pass [gather ms, K1 ms on the same plan, cut segments, most "
                  f"partials]: {res[f'passes_{label}']} [{card}]", flush=True)
            gathered = sum(n * ids.shape[0] * W * table.element_size()
                           for table, ids, _, _, _, n in passes)
            res[f"gathered_GB_{label}"] = gathered / 1e9
            res[f"l2_floor_ms_{label}"] = gathered / (res["l2_GBps"] * 1e9) * 1e3
            print(f"{label}: ms per {label} by budget {json.dumps(res[f'sweep_{label}'])}; slabs "
                  f"{res[f'slabs_{label}']}; gathered {gathered / 1e9:.3f} GB, L2 floor "
                  f"{res[f'l2_floor_ms_{label}']:.3f} ms [{card}]", flush=True)
            rows_list = (batch.num_nodes, batch.inc.real.num_edges + batch.num_nodes)
            packs = [cs.pack_inputs(rows, 256, 8, dt, dev, torch.Generator().manual_seed(1), R=R)
                     for rows in rows_list]
            per = 1 if R is None else 2  # the epoch packs in train and eval
            if other is not None:
                for p in passes:
                    if not torch.equal(other_gather(other, *p[:5]),
                                       cseg.gather_segment_sum_cuda(*p[:5])):
                        raise AssertionError(f"the trees' gathers differ ({label})")
                g = alternate(args.pairs, {
                    "other": lambda: sum(n * cs.cuda_ms(lambda: other_gather(other, *p[:5]))
                                         for p in passes for n in [p[5]]),
                    "this": lambda: sum(n * cs.cuda_ms(lambda: cseg.gather_segment_sum_cuda(
                        *p[:5])) for p in passes for n in [p[5]])})
                res[f"gather_{label}"] = g
                print(f"{label}: the gather inside K1, ms per {label}: this {g['this']}, other "
                      f"{g['other']} [{card}]", flush=True)
            k4 = {"this": [], "this_alone": [], "amax": []}
            if other is not None:
                k4["other"] = []
            for yf, bV, ba in packs:
                ref = ck.gmax_plain(yf, ba, 8, 256) if R is None else torch.stack(
                    [ck.gmax_plain(yf[:, r], ba[r], 8, 256) for r in range(R)])
                alone, g_alone = cs.k4_launch_alone(yf, ba, 8, 256)
                alone()
                scores = yf.view(yf.shape[0], -1, yf.shape[-1])[..., 256:264]
                if not (torch.equal(ck.gmax_cuda(yf, ba, 8, 256), ref)
                        and torch.equal(g_alone, ref)
                        and (other is None or torch.equal(other_gmax(other, yf, ba, 8, 256),
                                                          ref))):
                    raise AssertionError(f"K4 differs from gmax_plain ({label})")
                sides = {"this": lambda: ck.gmax_cuda(yf, ba, 8, 256),
                         "this_alone": alone, "amax": lambda: torch.amax(scores, dim=0)}
                if other is not None:
                    sides["other"] = lambda: other_gmax(other, yf, ba, 8, 256)
                for _ in range(args.pairs):
                    for name in (["other"] if other else []) + ["this", "this_alone", "amax",
                                                                 "amax", "this_alone", "this"] + (
                            ["other"] if other else []):
                        k4[name].append(per * cs.cuda_ms(sides[name], iters=50))
            # each reading summed over the step's or the epoch's packs
            m = 2 * args.pairs
            res[f"k4_{label}"] = {k: [sum(v[i * m + j] for i in range(len(packs)))
                                      for j in range(m)] for k, v in k4.items()}
            print(f"{label}: K4 ms per {label} (wrapper, launch alone, torch.amax"
                  f"{', other tree' if other else ''}): {json.dumps(res[f'k4_{label}'])} "
                  f"[{card}]", flush=True)
            del batch, passes, packs
            torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
