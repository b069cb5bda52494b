"""The runs-folded f32 dense product (ops/cuda_dense.py, csrc/runs_dense.cu).

On the CPU: the gate admits every f32 product of the benchmark's two
configurations (hgbench/configs/) at their cells' row counts, and its
answer never changes with the number of runs; the column tiles and dW's
row chunks cover their shapes; the weight stages' layout as
``runs_dense_slabs_kernel`` indexes it, emulated, against its plain
version. On the card (``cuda``): forward, dX, dW and db against f64
products at the cells' shapes, each within twice the error of
``torch.matmul`` in f32; an input shared by the runs; a run alone equal
bit for bit to the same run in a fold of 3; the weight stages bit for bit
against their plain version; a shape below the gate taking the library's
route and counting as declined."""

import json
import os

import pytest
import torch

import allset_tpu_torch.data.synthetic as tsyn
import allset_tpu_torch.graph.transforms as ttr
from allset_tpu_torch.graph.batch import Batch
from allset_tpu_torch.models import SetGNN, SetGNNConfig
from allset_tpu_torch.nn.modules import TorchDense
from allset_tpu_torch.ops import _kernels, cuda_dense as cd
from allset_tpu_torch.ops.cuda_pma import tf32_split

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL_ROWS = (88_860, 158_766)  # the cells' node rows and hyperedge rows with self-loops
# (traffic file, configuration file) of each cell: hgbench/BENCHMARK.json's
CELLS = (("walmart-r20", "allset_transformer-walmart"),
         ("walmart-r20-c10", "allset_deepsets-walmart"),
         ("scalefree-r20", "allset_transformer-walmart"))


def _json(*parts):
    with open(os.path.join(REPO, "hgbench", *parts)) as f:
        return json.load(f)


def _cell_model(traffic: str, config: str, runs: int = 2):
    """The cell's model (its configuration, the traffic's features and
    classes) on a small graph on the CPU, with ``runs`` runs."""
    c, g = _json("configs", config + ".json"), _json("traffic", traffic + ".json")["graph"]
    hd = tsyn.synthetic_hypergraph(num_nodes=200, num_hyperedges=90,
                                   num_classes=g["num_classes"], feature_dim=g["feature_dim"],
                                   seed=1)
    tb = Batch.from_hyperdata(ttr.norm_construction(ttr.add_self_loops(hd), c["normtype"]),
                              device="cpu", bucket=64)
    kw = dict(num_features=g["feature_dim"], num_classes=g["num_classes"],
              all_num_layers=c["All_num_layers"], mlp_num_layers=c["MLP_num_layers"],
              mlp_hidden=c["MLP_hidden"], classifier_num_layers=c["Classifier_num_layers"],
              classifier_hidden=c["Classifier_hidden"], heads=c["heads"],
              dropout=c["dropout"], normalization=c["normalization"],
              deepset_input_norm=c["deepset_input_norm"], nnz_padded=tb.inc.nnz_padded)
    cfg = SetGNNConfig.all_deep_sets(**kw) if c["method"] == "AllDeepSets" \
        else SetGNNConfig(**kw, aggregate=c["aggregate"])
    gens = [torch.Generator().manual_seed(s) for s in range(runs)]
    return SetGNN(cfg, gens), tb, gens


@pytest.mark.parametrize("traffic,config", CELLS)
def test_gate_admits_every_product_of_the_cells(traffic, config, monkeypatch):
    """Every dense product a training step and an evaluation forward of
    the cell's model ask for (TorchDense's and PMA's, recorded at the
    routing call) is one the kernels take at both of the cells' row
    counts: no f32 product of the cells is declined (PERF.md §3)."""
    calls = []

    def record(x, W):
        calls.append((tuple(x.shape), tuple(W.shape)))
        return False

    monkeypatch.setattr(cd, "route", record)
    model, tb, gens = _cell_model(traffic, config)
    model(tb, True, gens).square().mean().backward()
    with torch.no_grad():
        model(tb, False)
    pma = config == "allset_transformer-walmart"
    assert len(calls) == (6 if pma else 18)  # 3 or 9 products, training and evaluation
    for xs, ws in calls:
        for rows in CELL_ROWS:
            assert cd.takes((rows,) + xs[1:], ws), (xs, ws)


@pytest.mark.parametrize("K,N", [(100, 264), (256, 264), (256, 11), (256, 256), (7, 3)])
def test_gate_never_reads_the_runs(K, N):
    """The gate's answer, for a fold of R runs, a shared input and a
    single run, is the same at every row count."""
    for rows in (1, cd.DENSE_MIN_ROWS - 1, cd.DENSE_MIN_ROWS, *CELL_ROWS):
        want = cd.takes((rows, K), (K, N))
        assert want == cd.admits(rows, K, N)
        for R in (1, 2, 3, 10, 20):
            assert cd.takes((rows, R, K), (R, K, N)) == want
            assert cd.takes((rows, K), (R, K, N)) == want
    assert not cd.takes((5000, 3, 8), (2, 8, 4))  # runs that do not match
    assert not cd.takes((5000, 3, 8, 2), (3, 8, 4))  # a layout the kernels do not read


def test_tiles_and_chunks_cover_their_shapes():
    for N in (1, 8, 11, 100, 256, 264, 265, 528, 1000):
        np_, ntn = cd.col_tiles(N)
        assert np_ in cd.NP_BUCKETS and ntn * 8 * np_ >= N > (ntn - 1) * 8 * np_ - 8 * np_
        assert 8 * np_ <= 136
    assert cd.col_tiles(264) == (17, 2) and cd.col_tiles(256) == (16, 2)
    assert cd.col_tiles(11) == (2, 1) and cd.col_tiles(100) == (16, 1)
    for rows in (1, 31, 1024, 5000, *CELL_ROWS):
        nch, chunk = cd.chunk_plan(rows)
        assert chunk % cd.KR == 0 and (nch - 1) * chunk < rows <= nch * chunk
        assert nch <= cd.CHUNKS_MAX


def _slabs_emulated(Bt: torch.Tensor, np_: int, ntn: int) -> torch.Tensor:
    """runs_dense_slabs_kernel's index arithmetic, thread by thread."""
    R, Nn, Kk = Bt.shape
    TN, Kp = 8 * np_, -(-Kk // cd.KA) * cd.KA
    hi, lo = tf32_split(Bt.float())
    out = torch.zeros(R * ntn * Kp * TN * 2)
    for idx in range(R * ntn * Kp * TN):
        i = idx
        v, i = i & 3, i >> 2
        row8, i = i & 7, i >> 3
        ng, i = i % (TN // 8), i // (TN // 8)
        kc, i = i & 3, i >> 2
        s, i = i % (Kp // 16), i // (Kp // 16)
        tn, r = i % ntn, i // ntn
        n, k = tn * TN + 8 * ng + row8, 16 * s + 4 * kc + v
        o = ((r * ntn + tn) * (Kp // 16) + s) * 32 * TN + kc * 4 * TN + ng * 32 + row8 * 4 + v
        if n < Nn and k < Kk:
            out[o], out[o + 16 * TN] = hi[r, n, k], lo[r, n, k]
    return out.view(R, ntn, Kp // 16, 2, 16 * TN)


@pytest.mark.parametrize("Nn,Kk,np_,ntn", [(11, 20, 2, 1), (24, 40, 2, 2), (70, 33, 8, 2)])
def test_slab_layout_is_the_plain_versions(Nn, Kk, np_, ntn):
    gen = torch.Generator().manual_seed(Nn)
    Bt = torch.randn(2, Kk, Nn, generator=gen).transpose(1, 2)  # a transposed view
    assert torch.equal(_slabs_emulated(Bt, np_, ntn), cd.slabs_plain(Bt, np_, ntn))


# --- on the card ----------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _max_err(got, want):
    return (got.double() - want).abs().max().item()


# (rows, K, N, bias): the cells' products, K 100/256, N 11/256/264
CELL_PRODUCTS = [(88_860, 100, 264, False), (158_766, 256, 264, False),
                 (88_860, 256, 11, True), (88_860, 100, 256, True),
                 (158_766, 256, 256, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,K,N,bias", CELL_PRODUCTS)
def test_products_at_the_cells_shapes_against_f64(rows, K, N, bias):
    """Forward, dX, dW and db of 20 runs against f64 products: each error
    at most twice ``torch.matmul``'s in f32 (TF32 off) on the same
    operands."""
    dev, R = _card(), 20
    gen = torch.Generator(device=dev).manual_seed(rows + K + N)
    x = torch.randn(rows, R, K, device=dev, generator=gen).requires_grad_()
    W = (torch.randn(R, K, N, device=dev, generator=gen) / K ** 0.5).requires_grad_()
    b = torch.randn(R, N, device=dev, generator=gen).requires_grad_() if bias else None
    gy = torch.randn(rows, R, N, device=dev, generator=gen)
    _kernels.reset_launches()
    y = cd.runs_dense(x, W, b)
    y.backward(gy)
    assert _kernels.launches["runs_dense_mm"] == 2 and _kernels.launches["runs_dense_dw"] == 1
    errs = {}  # name: (the kernel's largest error, torch.matmul's)
    with torch.no_grad():
        for r in range(R):  # run by run: the f64 tables of all 20 would not fit
            xr, gr, Wr = x[:, r], gy[:, r], W[r]
            x64, g64, W64 = xr.double(), gr.double(), Wr.double()
            pairs = {  # name: (kernel, torch.matmul in f32, f64)
                "y": (y[:, r], torch.matmul(xr, Wr), torch.matmul(x64, W64)),
                "dx": (x.grad[:, r], torch.matmul(gr, Wr.t()), torch.matmul(g64, W64.t())),
                "dW": (W.grad[r], torch.matmul(xr.t(), gr), torch.matmul(x64.t(), g64)),
            }
            if bias:  # the kernel's y has its bias
                got, lib, want = pairs["y"]
                pairs["y"] = (got, lib + b[r], want + b[r].double())
                pairs["db"] = (b.grad[r], gr.sum(0), g64.sum(0))
            for name, (got, lib, want) in pairs.items():
                e = (_max_err(got, want), _max_err(lib, want))
                errs[name] = tuple(map(max, errs.get(name, (0.0, 0.0)), e))
    for name, (err, lib_err) in errs.items():
        assert err <= 2 * lib_err, (name, err, lib_err)


@pytest.mark.cuda
def test_shared_input_and_a_run_alone_against_a_fold():
    """A run alone (x [rows, K], W [K, N]) equals the same run in a fold of
    3 bit for bit, forward and every gradient; a shared x [rows, K] gives
    each run the bits of that run alone, and dx the runs' sum."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, K, N = 10_007, 100, 264
    x3 = torch.randn(rows, 3, K, device=dev, generator=gen)
    W3 = torch.randn(3, K, N, device=dev, generator=gen) / 10
    b3 = torch.randn(3, N, device=dev, generator=gen)
    gy = torch.randn(rows, 3, N, device=dev, generator=gen)

    def run(x, W, b, g):
        x, W, b = (t.detach().clone().requires_grad_() for t in (x, W, b))
        y = cd.runs_dense(x, W, b)
        y.backward(g)
        return y.detach(), x.grad, W.grad, b.grad

    fold = run(x3, W3, b3, gy)
    for r in range(3):
        alone = run(x3[:, r].contiguous(), W3[r], b3[r], gy[:, r].contiguous())
        for f, a in zip(fold, alone):
            assert torch.equal(f[:, r] if f.dim() == 3 and f.shape[0] == rows else f[r], a)
    xs = x3[:, 0].contiguous()
    shared = run(xs, W3, b3, gy)
    for r in range(3):
        alone = run(xs, W3[r], b3[r], gy[:, r].contiguous())
        assert torch.equal(shared[0][:, r], alone[0])
        assert torch.equal(shared[2][r], alone[2]) and torch.equal(shared[3][r], alone[3])
    dx64 = torch.einsum("mrn,rkn->mk", gy.double(), W3.double())
    assert _max_err(shared[1], dx64) <= 1e-4 * dx64.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("Nn,Kk", [(264, 100), (11, 256), (256, 264), (600, 40)])
def test_weight_stages_are_their_plain_version(Nn, Kk):
    dev = _card()
    Bt = torch.randn(3, Kk, Nn, device=dev).transpose(1, 2)
    np_, ntn = cd.col_tiles(Nn)
    assert torch.equal(cd.slabs(Bt, np_, ntn), cd.slabs_plain(Bt, np_, ntn))


@pytest.mark.cuda
def test_a_declined_shape_takes_the_library_route():
    """Below the gate's rows a TorchDense product on the card launches no
    kernel, counts as declined and gives the plain version's bits."""
    dev = _card()
    rows = cd.DENSE_MIN_ROWS - 1
    lin = TorchDense(64, 40, [torch.Generator().manual_seed(s) for s in range(3)]).to(dev)
    x = torch.randn(rows, 3, 64, device=dev)
    _kernels.reset_launches()
    y = lin(x)
    assert _kernels.declined["runs_dense"] == 1
    assert all(_kernels.launches[k] == 0 for k in _kernels.DENSE_KERNELS)
    want = torch.stack([x[:, r].contiguous() @ lin.kernel[r] + lin.bias[r] for r in range(3)], 1)
    assert torch.equal(y, want)
    big = torch.randn(cd.DENSE_MIN_ROWS, 3, 64, device=dev)
    lin(big)
    assert _kernels.declined["runs_dense"] == 1 and _kernels.launches["runs_dense_mm"] == 1
