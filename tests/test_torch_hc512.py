"""AllSetTransformer at MLP_hidden 512, the benchmark cell
``ast-walmart-hc512-r20`` (``hgbench/configs/allset_transformer-walmart-hc512.json``
under ``hgbench/traffic/walmart-r20-g20.json``).

On the CPU: at the cell's shapes the epilogue takes the two-block cluster
kernels (K2R and K3a) and the dense pair takes every product; the
trainer's memory estimate that made the traffic pin its fold; the port's
plain path against the plain reference (``hgbench/reference/``) at the
configuration's widths, within the cell's limits; a CPU fit counts no
cluster launch and no declined epilogue call. On the card (``cuda``): the
same comparison through the cluster route, which the epochs count."""

import copy
import sys
import types

import pytest
import torch

from allset_tpu_torch.ops import _kernels, cuda_dense as cd
from allset_tpu_torch.ops import cuda_pma
from allset_tpu_torch.utils import profiling as prof
from hgbench import compare, control, graphs, manifest, program
from hgbench import spans as hspans
from hgbench.costs import packed_width
from hgbench.reference.follow import follow
from test_torch_dense import CELL_ROWS, _cell_model

WORKLOAD = "ast-walmart-hc512-r20"
CELL = manifest.cell(WORKLOAD)
HC, H, L = CELL.config["MLP_hidden"], CELL.config["heads"], CELL.config["MLP_num_layers"]
RUNS = CELL.traffic["job"]["runs"]
STEPS = 3
# a walmart-shaped graph a test holds (hgbench/tests/tiny.py's)
SMALL = {"generator": "cornell_like", "graph_seed": 0, "num_nodes": 400, "num_hyperedges": 300,
         "avg_edge_size": 5, "num_classes": 5, "feature_dim": 24, "feature_noise": 1.0,
         "exponent": 1.2, "homophily": 0.6}


def _small_cell(runs=3, graph=SMALL):
    """The cell at the configuration's widths on ``graph`` (the small one by
    default): ``runs`` runs folded into one group, STEPS epochs, the cell's
    own limits."""
    cell = copy.deepcopy(CELL)
    cell.traffic = {"graph": dict(graph),
                    "job": dict(CELL.traffic["job"], runs=runs, epochs=STEPS, vmap_chunk=None)}
    return cell


def test_the_cell_is_the_published_width():
    assert (HC, H, L, RUNS) == (512, 8, 2, 20)
    assert CELL.traffic["job"]["vmap_chunk"] == RUNS
    assert CELL.config["Classifier_hidden"] == 128 and CELL.config["dtype"] == "float32"


@pytest.mark.parametrize("rows", CELL_ROWS)
def test_the_epilogue_takes_the_cluster_kernels(rows):
    """K2R and K3R at the cell's shapes: packed width 520, 20 runs, each of
    the two half-layers' rows; 64-row tiles, the cluster K3a's full grid."""
    WP = packed_width(HC, H)
    assert WP == 520
    assert cuda_pma.epilogue_route(HC, H, L, WP, RUNS) == "kernel"
    assert cuda_pma.fwd_kernel(HC, torch.float32) == "cluster"
    assert cuda_pma.bwd_kernel(HC, torch.float32) == "cluster"
    assert cuda_pma.tile_rows(HC) == 64
    assert cuda_pma.cluster_bwd_entries(rows) == cuda_pma.CLUSTER_BWD_ENTRIES
    Mp, chunk, nch = cuda_pma.wg_chunk_plan(rows)
    assert Mp >= rows and chunk * nch >= Mp and nch <= cuda_pma.DW_PARTIALS


def test_the_dense_pair_takes_every_product(monkeypatch):
    """Every dense product of a training step and an evaluation forward of
    the configuration (the [lin_V | Wa] products into 520 columns, the
    classifier) is one the kernels take at both of the cell's row counts."""
    calls = []

    def record(x, W):
        calls.append((tuple(x.shape), tuple(W.shape)))
        return False

    monkeypatch.setattr(cd, "route", record)
    model, tb, gens = _cell_model("walmart-r20-g20", "allset_transformer-walmart-hc512")
    model(tb, True, gens).square().mean().backward()
    with torch.no_grad():
        model(tb, False)
    assert len(calls) == 6  # 3 products, training and evaluation
    assert {ws[-1] for _, ws in calls} == {packed_width(HC, H), CELL.traffic["graph"]
                                           ["num_classes"]}
    for xs, ws in calls:
        for rows in CELL_ROWS:
            assert cd.takes((rows,) + xs[1:], ws), (xs, ws)


def test_the_estimate_that_pins_the_fold():
    """The trainer's estimate at the cell's graph (the traffic's ``why``):
    3.477 GiB a run, so 20 runs come within a few GiB of 0.9 of an 80 GB
    card's free memory, and the traffic fixes the fold at 20."""
    g = graphs.make_graph(CELL.traffic["graph"], 7)
    system = program.prepare_system(CELL.config, CELL.traffic["job"], g, 7, STEPS, "cpu")
    assert system.job.batch.num_nodes == CELL_ROWS[0]
    assert system.job.batch.inc.real.num_edges + CELL_ROWS[0] == CELL_ROWS[1]
    assert round(system.job._bytes_per_run() / 2**30, 3) == 3.477
    assert system.job._group_size() == RUNS


def test_a_plain_route_on_the_card_counts_as_declined(monkeypatch):
    """An epilogue call on a CUDA tensor that ``epilogue_route`` sends to
    the plain route (an rFF of 3 layers) counts in
    ``declined["pma_epilogue"]``; a CPU call and a kernel's shape do not;
    ``reset_launches`` empties the counters."""
    monkeypatch.setitem(_kernels.declined, "pma_epilogue", 0)

    def call(HC, L, R, cuda=True):
        agg = types.SimpleNamespace(is_cuda=cuda, device=torch.device("cpu"),
                                    shape=(64, R * packed_width(HC, H)))
        seed = torch.zeros((R, HC) if R > 1 else (HC,))
        return cuda_pma._use_kernel(agg, seed, torch.zeros(L, HC, HC), H)

    assert call(HC, L, RUNS) and call(HC, L, 1)
    assert _kernels.declined["pma_epilogue"] == 0
    assert not call(HC, 3, RUNS) and not call(HC, 3, RUNS, cuda=False)
    assert _kernels.declined["pma_epilogue"] == 1
    monkeypatch.setitem(_kernels.routes, "pma_fwd_cluster", 4)
    _kernels.reset_launches()
    assert _kernels.declined["pma_epilogue"] == 0 and _kernels.routes["pma_fwd_cluster"] == 0


def test_cluster_launches_without_the_count_read_none(monkeypatch):
    """A traced fit whose epochs carry no ``pma_cluster`` count (a program
    without the counter) gives the reader nothing to read."""
    epoch = types.SimpleNamespace(name="trainer.epoch", id=2, parent=1, fit=1, profiled=True,
                                  counts={"launches": 48})
    fit = types.SimpleNamespace(name="trainer.fit", id=1, parent=None, fit=1, profiled=True,
                                counts={})
    monkeypatch.setitem(sys.modules, hspans.MODULE, types.SimpleNamespace(
        spans=lambda: [epoch, fit], dropped=lambda: 0))
    read = manifest.reader("cluster_launches_per_epoch").read
    assert read(types.SimpleNamespace(epochs=1)) is None
    epoch.counts["pma_cluster"] = 6
    assert read(types.SimpleNamespace(epochs=1)) == 6.0


def _numbers(cell, seed, device):
    g = graphs.make_graph(cell.traffic["graph"], seed)
    want = follow(cell.config, cell.traffic["job"], g, seed, STEPS, device)
    return control.program_numbers(cell, seed, device, STEPS, want)


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_plain_path_follows_the_reference(seed):
    """3 folded runs x 3 steps at the configuration's widths on the CPU:
    losses, first gradients and updates within the cell's limits."""
    cell = _small_cell()
    nums = _numbers(cell, seed, "cpu")
    assert compare.judge(nums, cell.limits), nums


def test_a_cpu_fit_counts_no_cluster_launch():
    cell = _small_cell(runs=2)
    g = graphs.make_graph(cell.traffic["graph"], 5)
    system = program.prepare_system(cell.config, cell.traffic["job"], g, 5, STEPS, "cpu")
    prof.reset()
    system.check.fit()
    epochs = [s for s in prof.spans() if s.name == "trainer.epoch"]
    assert len(epochs) == STEPS
    assert all(s.counts["pma_cluster"] == 0 and s.counts["pma_declined"] == 0 for s in epochs)


@pytest.mark.cuda
def test_cluster_route_follows_the_reference_on_the_card():
    """The comparison above through the card's route, on the cell's own
    graph (at the small one Adam's first steps turn rounding in
    near-zero gradients into whole steps, and the evaluation losses move
    by some 1e-4): every epoch launches the cluster K2R four times and K3a
    twice, and declines no epilogue call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the cluster kernels run only on the card)")
    cell = _small_cell(graph=CELL.traffic["graph"])
    prof.reset()
    nums = _numbers(cell, 3, "cuda")
    assert compare.judge(nums, cell.limits), nums
    epochs = [s for s in prof.spans() if s.name == "trainer.epoch"]
    assert len(epochs) == STEPS
    assert all(s.counts["pma_cluster"] == 6 and s.counts["pma_declined"] == 0 for s in epochs)
