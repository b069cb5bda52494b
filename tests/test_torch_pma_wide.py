"""K2/K3 and K2R/K3R above HC 512 (the wide route, csrc/pma_epilogue_wide_wg.cu)
on the host: the plain versions with the kernels' split products against
the JAX kernel in interpret mode at HC 640 (one run and the R = 2 runs
grid); the product slabs read back at the kernel's stage and descriptor
offsets; the 128-row tile plan and the dW chunk plan; the scratch the
trainer counts; and the route's launch sequence (its buffers, the dp_0
table that replaces h1 in f32, the partials' rows) with every C entry
emulated in PyTorch, against the plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allset_tpu.ops.pallas_pma import _pallas_bwd, _pallas_fwd
from allset_tpu_torch.ops import _kernels, cuda_pma as cp
from tests.test_torch_pma import _check_against_jax, split_mm, tf32
from tests.test_torch_runs_epilogue import _inputs as runs_inputs

F32, BF16 = torch.float32, torch.bfloat16


# --- the plain versions at HC 640 against the JAX kernel -------------------------


@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_epilogue_at_hc_640_on_split_products_matches_jax_kernel(dtype, L, monkeypatch):
    """HC 640 (the narrowest wide width), 8 heads, 45 rows (not a multiple
    of the JAX kernel's 32-row block) with the kernels' 3xTF32 products (a
    bf16 operand's low part 0): values and gradients within the JAX
    kernel's own tolerances (f32 2e-5 forward, 1e-4 gradients; bf16 5e-2,
    6e-2), as test_torch_pma.py holds the narrower widths."""
    monkeypatch.setattr(cp, "_mm", split_mm)
    _check_against_jax(dtype, L, True, 8, 640, 45, 648, blk=32)


@pytest.mark.parametrize("L", [1, 2])
def test_runs_epilogue_at_hc_640_matches_jax_runs_grid(L, monkeypatch):
    """K2R/K3R's plain versions with the split products at HC 640, R = 2,
    45 rows, against the JAX package's R > 1 grids in interpret mode:
    1e-5 on y, 1e-5 absolute and 1e-4 relative on the gradients (the
    tolerances of test_torch_runs_epilogue.py)."""
    monkeypatch.setattr(cp, "_mm", split_mm)
    R, M, HC, H, WP = 2, 45, 640, 8, 648
    agg, params, gy = runs_inputs(L, R=R, floor=False, M=M, HC=HC, H=H, WP=WP)
    kw = dict(H=H, blk=32, interpret=True, relu=True, R=R)
    jargs = [jnp.asarray(p) for p in params]
    y_ref = _pallas_fwd(jnp.asarray(agg), *jargs, **kw)
    dagg_ref, dW_ref, ds_ref = _pallas_bwd(jnp.asarray(agg), jnp.asarray(gy), *jargs, **kw)
    targs = [torch.from_numpy(p) for p in params]
    y = cp.epilogue_fwd_runs(torch.from_numpy(agg), *targs, H, True)
    dagg, dW, ds = cp.epilogue_bwd_runs(torch.from_numpy(agg), torch.from_numpy(gy), *targs,
                                        H, True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5, rtol=1e-5)
    for got, want in ((dagg, dagg_ref), (dW, np.asarray(dW_ref).reshape(R, L, HC, HC)),
                      (ds, np.asarray(ds_ref).reshape(R, 8, HC))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


# --- the slabs, the plans, the scratch ----------------------------------------------


def stage_element(slabs, n, k, part=0):
    """B[n][k] read back from wide_slabs' bytes (one run and layer) as the
    product kernel addresses them: column tile n // 128, stage k // KA (KA
    = 128 bytes of k), B_BYTES a stage; in a stage, bf16: chunk (k % 64) //
    8 at LBO = 2048 bytes; f32: slab (k % 32) // 16 of 16 KB, its hi part
    then its lo part 8 KB on, chunk (k % 16) // 4 at LBO; then row group
    (n % 128) // 8 at 128 bytes, row n % 8 at 16, element k % V."""
    item = slabs.element_size()
    KA = 128 // item if item == 2 else 32
    B_BYTES = KA * 128 * (2 if item == 2 else 8)
    K = slabs.shape[-6] * slabs.shape[-4] * slabs.shape[-1]
    flat = slabs.reshape(-1)
    byte = ((n // 128) * (K // KA) + k // KA) * B_BYTES
    if item == 2:
        byte += ((k % 64) // 8) * 2048 + (k % 8) * 2
    else:
        byte += ((k % 32) // 16) * 16384 + part * 8192 + ((k % 16) // 4) * 2048 + (k % 4) * 4
    byte += ((n % 128) // 8) * 128 + (n % 8) * 16
    return flat[byte // item]


@pytest.mark.parametrize("HC", [640, 1024])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_wide_slabs_follow_the_stage_layout(HC, dtype):
    """wide_fwd_weights (B = W^T, bf16 or TF32 hi | lo) and wide_bwd_weights
    (B = W, TF32 hi | lo in both dtypes) hold every element where the
    product kernel's stages and descriptors read it: hi is exact in TF32,
    |W - hi - lo| <= 2^-22 |W|; the bf16 slabs hold W rounded."""
    rng = np.random.default_rng(HC)
    L = 2
    W = torch.from_numpy(rng.normal(size=(L, HC, HC)).astype(np.float32))
    for slabs, B in ((cp.wide_fwd_weights(W, dtype), W.transpose(-1, -2)),
                     (cp.wide_bwd_weights(W), W)):
        assert slabs.shape[:3] == (L, HC // 128, HC // (64 if slabs.dtype == BF16 else 16))
        for l in range(L):
            for n, k in ((0, 0), (7, 5), (HC - 1, HC - 1), (HC // 2 + 3, 77), (129, HC - 17),
                         (300, 31), (511, 32)):
                b = B[l, n, k]
                hi = stage_element(slabs[l], n, k, 0)
                if slabs.dtype == BF16:
                    assert hi == b.to(BF16)
                    continue
                lo = stage_element(slabs[l], n, k, 1)
                assert hi == tf32(b.reshape(1))[0] and lo == tf32((b - hi).reshape(1))[0]
                assert abs(float(b) - float(hi) - float(lo)) <= abs(float(b)) * 2.0 ** -22


@pytest.mark.parametrize("HC,L", [(640, 1), (640, 2), (1024, 2), (1536, 2), (2048, 1)])
def test_wide_plans_cover_every_row_once(HC, L):
    """The 128-row tiles and the dW chunks cover rows [0, M) once each, for
    M below a tile, not a multiple of it, and at the bench step's rows;
    chunks of a multiple of 32 rows (the dW kernel's stages), at most
    DW_PARTIALS of them, and at the bench step's and walmart's rows about
    WIDE_DW_BLOCKS dW blocks a layer."""
    for M in (1, 45, 127, 128, 129, 1000, 5000, 158_766, 196_608):
        tiles = cp.wide_tiles(M)
        assert (tiles - 1) * cp.WIDE_TR < M <= tiles * cp.WIDE_TR
        rows, nch = cp.wide_dw_plan(M, HC, L)
        assert rows % 32 == 0 and 1 <= nch <= cp.DW_PARTIALS
        covered = np.zeros(M, np.int64)
        for ch in range(nch):
            covered[ch * rows:min(M, (ch + 1) * rows)] += 1
        assert (covered == 1).all()
        if M >= 100_000:  # far above the 32-row rounding of the chunks
            assert nch * (HC // 128) ** 2 >= min(cp.WIDE_DW_BLOCKS,
                                                 cp.DW_PARTIALS * (HC // 128) ** 2) * 0.9


def _recording(monkeypatch):
    """Record every torch.empty and every wide slab tensor made from here
    on; returns the list."""
    made, empty = [], torch.empty
    fwd, bwd = cp.wide_fwd_weights, cp.wide_bwd_weights

    def rec(fn):
        def wrapped(*a, **k):
            made.append(fn(*a, **k))
            return made[-1]
        return wrapped

    monkeypatch.setattr(torch, "empty", rec(empty))
    monkeypatch.setattr(cp, "wide_fwd_weights", rec(fwd))
    monkeypatch.setattr(cp, "wide_bwd_weights", rec(bwd))
    return made


@pytest.mark.parametrize("HC", list(range(640, 2049, 128)))
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_wide_scratch_bytes_match_the_route(HC, dtype, monkeypatch):
    """bwd_scratch_bytes, which the trainer counts per run, is what K3R's
    wide setup makes beside its outputs (its tables, partials and slabs) at
    every wide width to 2048, L 1 and 2, both dtypes, 3 runs: 16 bytes a
    row and column at L = 2 in both dtypes (zb, h1, dp_1, dp_0 (in f32 over
    h1) tiled over M rounded up to 128 rows; p, then dz, over M)."""
    M, H, R = 300, 8, 3
    WP = HC + 8
    item = 2 if dtype == BF16 else 4
    for L in (1, 2):
        # the setup's checks and stream need a CUDA tensor; its allocations do not
        monkeypatch.setattr(cp, "_check_cuda_args", lambda *a: (M, WP, HC, L))
        monkeypatch.setattr(_kernels, "stream_ptr", lambda t: 0)
        made = _recording(monkeypatch)
        agg, gy = torch.zeros(M, R * WP, dtype=dtype), torch.zeros(M, R * HC, dtype=dtype)
        small = [torch.zeros(R, HC)] * 3
        W, brff, g1, b1 = (torch.zeros(R, L, HC, HC), torch.zeros(R, L, HC),
                           *[torch.zeros(R, HC)] * 2)
        _, outs = cp._bwd_setup(agg, gy, *small, W, brff, g1, b1, H, True, R)
        cp.wide_fwd_weights(W, dtype)  # made (and recorded) by the call, for its products
        monkeypatch.undo()
        scratch = [t for t in made if not any(t is o for o in outs)]
        assert sum(t.nbytes for t in scratch) == R * cp.bwd_scratch_bytes(M, HC, L, item)
        Mp = cp.wide_tiles(M) * cp.WIDE_TR
        tables = [t for t in scratch if t.shape in ((R, Mp, HC), (R, M, HC))]
        assert sum(t.nbytes for t in tables) == R * HC * (
            Mp * (12 if L == 2 else 4 + item) + 4 * M)
        nch = cp.wide_dw_plan(M, HC, L)[1]
        assert any(t.shape == (R, nch, L, HC, HC) for t in scratch)
        assert any(t.shape == (R, cp.wide_tiles(M), 8, HC) for t in scratch)


# --- the launch sequence, every C entry emulated -------------------------------------


def _unslab(slabs):
    """wide_slabs' inverse: [..., L, NT, NS, parts, ks / V, 16, 8, V] ->
    [..., L, parts, N, K]."""
    *lead, L, NT, NS, P, KC, NB, NI, V = slabs.shape
    nd = len(lead)
    x = slabs.permute(*range(nd), nd, nd + 3, nd + 1, nd + 5, nd + 6, nd + 2, nd + 4, nd + 7)
    return x.reshape(*lead, L, P, NT * NB * NI, NS * KC * V).float()


def tab_index(M, HC, item):
    """[M, HC]: the element offset of (m, c) in a run's tiled table, as the
    kernels' tab() computes it: 128-row tiles, KA = 128 bytes of columns a
    block, the 16-byte chunks of a row XOR-swizzled by its low 3 bits."""
    KA, V = 128 // item, 16 // item
    m, c = torch.arange(M)[:, None], torch.arange(HC)[None, :]
    rr, cc = m % 128, c % KA
    return ((((m // 128) * (HC // KA) + c // KA) * 128 + rr) * KA
            + ((cc // V) ^ (rr % 8)) * V + cc % V)


def _runs_view(t, R, rows, HC):
    """The first R * rows * HC elements of t as [R, rows * HC] (a pass's
    tables are the heads of larger buffers)."""
    return t.reshape(-1)[: R * rows * HC].view(R, -1)


def untile(t, R, M, HC):
    """A tiled table [R, Mp, HC] read as [R, M, HC]."""
    Mp = -(-M // 128) * 128
    return _runs_view(t, R, Mp, HC)[:, tab_index(M, HC, t.element_size())]


def tile_put(t, R, M, HC, x):
    """x [R, M, HC] written into the tiled table t."""
    Mp = -(-M // 128) * 128
    _runs_view(t, R, Mp, HC)[:, tab_index(M, HC, t.element_size()).reshape(-1)] = (
        x.reshape(R, -1).to(t.dtype))


def test_tiled_tables_are_a_permutation():
    """tab() sends the [M, HC] elements of a run to distinct places of its
    Mp x HC table, each 128 x KA block of 16 KB contiguous, for both item
    sizes (the product kernel's one bulk copy a stage)."""
    for M, HC in ((45, 640), (300, 1024), (128, 768)):
        Mp = cp.wide_tiles(M) * cp.WIDE_TR
        for item in (2, 4):
            idx = tab_index(Mp, HC, item)
            assert idx.unique().numel() == Mp * HC and idx.max() == Mp * HC - 1
            KA = 128 // item
            block = idx[:128, :KA]
            assert block.min() == 0 and block.max() == 128 * KA - 1


def _split(a):
    hi = tf32(a.contiguous())
    return hi, tf32((a - hi).contiguous())


class _WideLib:
    """The wide route's four C entries in PyTorch, on CPU tensors found by
    their data pointers: the kernels' arithmetic (3xTF32 split products, A
    split as the registers split it, B's hi and lo from the slabs; bf16
    products exact in f64), their tables, their partials per 128-row tile
    and dW chunk."""

    def __init__(self, tensors):
        self.tensors = tensors
        self.calls = []

    def _t(self, ptr):
        """The tensor at ptr, or, inside one (a pass's rows), its elements
        from there on, flat."""
        if not ptr:
            return None
        for t in self.tensors:
            if t.data_ptr() == ptr:
                return t
        for t in self.tensors:
            off = ptr - t.data_ptr()
            if 0 < off < t.numel() * t.element_size():
                return t.reshape(-1)[off // t.element_size():]
        raise KeyError(ptr)

    def __getattr__(self, name):
        return getattr(self, "_" + name.removeprefix("allset_pma_wide_"))

    def _rows(self, mode, agg, gy, seed, g0, b0, g1, b1, zb, pz, dp, out, part, M, WP, HC, H,
              L, R, relu, dtype, stream):
        self.calls.append(("rows", mode))
        cdt = BF16 if dtype else F32
        agg, gy, seed, g0, b0, g1, b1, zb, pz, dp, out, part = map(
            self._t, (agg, gy, seed, g0, b0, g1, b1, zb, pz, dp, out, part))
        # the kernels' layouts: a leading run axis on every parameter and
        # table, zb and dp tiled
        agg = agg.reshape(-1)[: M * R * WP].view(M, R * WP)
        if gy is not None:
            gy = gy.reshape(-1)[: M * R * HC].view(M, R * HC)
        width = WP if mode == cp.ROW_LN0_BWD else HC
        out = None if out is None else out.reshape(-1)[: M * R * width].view(M, R * width)
        seed, g0, b0, g1, b1 = (t.view(R, HC) for t in (seed, g0, b0, g1, b1))
        zbt, pz = zb, _runs_view(pz, R, M, HC).view(R, M, HC)
        zb = untile(zbt, R, M, HC)
        dps = torch.zeros(R, M, HC)
        part = part if part is None else part.view(R, -1, 8, HC)
        for r in range(R):
            a = agg[:, r * WP:(r + 1) * WP].float()
            tiles = lambda x: torch.nn.functional.pad(x, (0, 0, 0, -M % 128)).reshape(
                -1, 128, HC).sum(1)
            if mode in (cp.ROW_LN0, cp.ROW_LN0_BWD):
                deninv = 1.0 / a[:, HC:HC + H].clamp_min(cp.DEN_FLOOR)
                denE = deninv.repeat_interleave(HC // H, dim=1)
                z, xhat, rstd = cp._ln(a[:, :HC] * denE + seed[r], g0[r], b0[r])
                if mode == cp.ROW_LN0:
                    zb[r] = z.to(cdt)
                    tile_put(zbt, R, M, HC, zb)
                    continue
                dz = pz[r].clone()
                d0, dg0, db0 = cp._ln_bwd(dz, xhat, rstd, g0[r])
                dden = -(d0 * a[:, :HC]).reshape(M, H, HC // H).sum(2) * deninv * deninv
                dden = torch.where(a[:, HC:HC + H] > cp.DEN_FLOOR, dden, torch.zeros_like(dden))
                out[:, r * WP:(r + 1) * WP] = torch.cat(
                    [d0 * denE, dden, torch.zeros(M, WP - HC - H)], 1).to(cdt)
                part[r, :, 0], part[r, :, 1], part[r, :, 2] = (tiles(d0), tiles(dz * xhat),
                                                               tiles(dz))
                part[r, :, 5 + L:] = 0.0
                continue
            p = pz[r].clone()
            y, xhat, rstd = cp._ln(zb[r].float() + p.clamp_min(0.0), g1[r], b1[r])
            y = y.to(cdt)
            if mode == cp.ROW_LN1:
                out[:, r * HC:(r + 1) * HC] = y.clamp_min(0) if relu else y
                continue
            g = gy[:, r * HC:(r + 1) * HC].float()
            if relu:
                g = g * (y.float() > 0)
            dout2, _, _ = cp._ln_bwd(g, xhat, rstd, g1[r])
            pz[r] = dout2
            dps[r] = dout2 * (p > 0)
            part[r, :, 3], part[r, :, 4] = tiles(g * xhat), tiles(g)
            part[r, :, 4 + L] = tiles(dps[r])
        if mode == cp.ROW_LN1_BWD:
            tile_put(dp, R, M, HC, dps)
        return 0

    def _gemm(self, mode, A, B, bias, h, out, part, M, HC, L, l, q, R, dtype, stream):
        self.calls.append(("gemm", mode, l))
        cdt = BF16 if dtype else F32
        A, B, bias, h, out, part = map(self._t, (A, B, bias, h, out, part))
        Bm = _unslab(B).reshape(R, L, -1, HC, HC)  # [R, L, parts, N, K]
        A = untile(A, R, M, HC)
        bias = bias if bias is None else bias.view(R, L, HC)
        ht = h
        h = h if h is None else untile(h, R, M, HC).clone()
        outt = out
        out = (_runs_view(out, R, M, HC).view(R, M, HC) if mode in (cp.EP_V, cp.EP_DZ)
               else torch.zeros(R, M, HC))
        part = part if part is None else part.view(R, -1, 8, HC)
        for r in range(R):
            a = A[r].float()
            if Bm.shape[-3] == 1:  # bf16 products
                acc = (a.double() @ Bm[r, l, 0].double().mT).float()
            else:
                ah, al = _split(a)
                bh, bl = Bm[r, l, 0].double().mT, Bm[r, l, 1].double().mT
                acc = (al.double() @ bh + ah.double() @ bl + ah.double() @ bh).float()
            if mode in (cp.EP_H, cp.EP_V):
                v = (acc.to(cdt).float() + bias[r, l]).to(cdt).float()
                if mode == cp.EP_H:
                    h[r] = v.clamp_min(0.0)
                else:
                    out[r] = v
            elif mode == cp.EP_DP:
                d = acc * (h[r].float() > 0)  # the mask before out, which may be h
                out[r] = d
                part[r, :, q] = torch.nn.functional.pad(d, (0, 0, 0, -M % 128)).reshape(
                    -1, 128, HC).sum(1)
            else:
                out[r] += acc
        if mode == cp.EP_H:
            tile_put(ht, R, M, HC, h)
        elif mode == cp.EP_DP:
            tile_put(outt, R, M, HC, out)
        return 0

    def _dw(self, h, dp, part_w, M, HC, L, l, R, nch, chunk_rows, dtype, stream):
        self.calls.append(("dw", l))
        h, dp, part_w = map(self._t, (h, dp, part_w))
        h, dp = untile(h, R, M, HC), untile(dp, R, M, HC)
        part_w = part_w.view(R, nch, L, HC, HC)
        assert chunk_rows % 32 == 0
        for r in range(R):
            for ch in range(nch):
                rows = slice(ch * chunk_rows, min(M, (ch + 1) * chunk_rows))
                if h.dtype == BF16:
                    hr = h[r, rows].double()
                    part_w[r, ch, l] = (hr.T @ dp[r, rows].double()).float()
                else:
                    part_w[r, ch, l] = split_mm(h[r, rows].T, dp[r, rows])
        return 0

    def _reduce(self, part_w, nch, dW, part_s, np_, dsmall, HC, L, R, stream):
        self.calls.append(("reduce",))
        part_w, dW, part_s, dsmall = map(self._t, (part_w, dW, part_s, dsmall))
        dW.view(R, L, HC, HC)[:] = part_w.view(R, nch, L, HC, HC).sum(1)
        dsmall.view(R, 8, HC)[:] = part_s.view(R, np_, 8, HC).sum(1)
        return 0


def _emulated(monkeypatch, inputs):
    """Route the wide K2/K3 wrappers' C calls to _WideLib on CPU tensors
    (the tensors they make are recorded, so the fake finds them by
    pointer); returns the fake library."""
    made = _recording(monkeypatch)
    made.extend(inputs)
    lib = _WideLib(made)
    monkeypatch.setattr(_kernels, "lib", lambda: lib)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(cp, "_check_cuda_args", _shape_only)
    return lib


def _shape_only(agg, seed, Wrff, H, R):
    """_check_cuda_args without its device check."""
    runs = 1 if R is None else R
    M, W = agg.shape
    HC, L = seed.shape[-1], Wrff.shape[-3]
    assert cp.epilogue_supported(HC, H, L, W // runs, runs)
    return M, W // runs, HC, L


@pytest.mark.parametrize("R", [None, 2])
@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_wide_launch_sequence_emulated_matches_plain(dtype, L, R, monkeypatch):
    """K2/K3 (R None) and K2R/K3R (R = 2) through the wide route's launches
    with each C entry emulated in PyTorch (_WideLib) at HC 640, 8 heads,
    300 rows (three 128-row tiles, the last short), relu on: the launches
    in the route's order (K2: LN0, the L products, LN1; K3: the forward
    again, LN1's backward, per layer dW and dp @ W^T, LN0's backward, the
    reduce), and y, dagg, dW and the small vectors within the chip
    checks' tolerances of the plain versions with the split products
    (f32: 2e-5 forward, 1e-4 gradients, scaled by the largest |.|; bf16:
    5e-2 and 6e-2)."""
    monkeypatch.setattr(cp, "_mm", split_mm)
    M, HC, H, WP = 300, 640, 8, 648
    runs = R or 1
    agg, params, gy = runs_inputs(L, R=runs, floor=True, M=M, HC=HC, H=H, WP=WP, seed=7)
    agg_t, gy_t = torch.from_numpy(agg).to(dtype), torch.from_numpy(gy).to(dtype)
    ps = [torch.from_numpy(p) for p in params]
    if R is None:
        ps = [p[0].contiguous() for p in ps]
    lib = _emulated(monkeypatch, [agg_t, gy_t, *ps])
    fwd = cp.epilogue_fwd_runs_cuda if R else cp.epilogue_fwd_cuda
    bwd = cp.epilogue_bwd_runs_cuda if R else cp.epilogue_bwd_cuda
    y = fwd(agg_t, *ps, H, True)
    fwd_calls = [("rows", cp.ROW_LN0)] + [("gemm", cp.EP_V if l == L - 1 else cp.EP_H, l)
                                          for l in range(L)]
    assert lib.calls == fwd_calls + [("rows", cp.ROW_LN1)]
    lib.calls.clear()
    dagg, dW, ds = bwd(agg_t, gy_t, *ps, H, True)
    mid = ([("dw", 1), ("gemm", cp.EP_DP, 1)] if L == 2 else [])
    assert lib.calls == fwd_calls + [("rows", cp.ROW_LN1_BWD), *mid, ("gemm", cp.EP_DZ, 0),
                                     ("dw", 0), ("rows", cp.ROW_LN0_BWD), ("reduce",)]
    monkeypatch.undo()
    monkeypatch.setattr(cp, "_mm", split_mm)
    plain_f = cp.epilogue_fwd_runs_plain if R else cp.epilogue_fwd_plain
    plain_b = cp.epilogue_bwd_runs_plain if R else cp.epilogue_bwd_plain
    y_ref = plain_f(agg_t, *ps, H, True)
    refs = plain_b(agg_t, gy_t, *ps, H, True)
    ftol, gtol = (2e-5, 1e-4) if dtype == F32 else (5e-2, 6e-2)
    scale = lambda t: max(t.float().abs().max().item(), 1.0)
    assert (y.float() - y_ref.float()).abs().max().item() / scale(y_ref) <= ftol
    for got, want in zip((dagg, dW, ds), refs):
        assert got.shape == want.shape and got.dtype == want.dtype
        g, w = got.float(), want.float()
        floor = w.abs() >= 1e6  # dvals at the 1e-16 floor: scaled apart
        for sel in (~floor, floor):
            if sel.any():
                assert (g[sel] - w[sel]).abs().max().item() / scale(w[sel]) <= gtol


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_wide_forward_in_passes_is_the_forward_in_one(dtype, monkeypatch):
    """K2 over 300 rows in passes of 128 rows (WIDE_FWD_BYTES cut to force
    them: three passes, the last short), each C entry emulated: the
    launches per pass in order, and y bit for bit that of one pass (every
    row is computed alike in any pass)."""
    M, HC, H, WP, L = 300, 640, 8, 648, 2
    agg, params, _ = runs_inputs(L, R=1, floor=True, M=M, HC=HC, H=H, WP=WP, seed=3)
    agg_t = torch.from_numpy(agg).to(dtype)
    ps = [torch.from_numpy(p)[0].contiguous() for p in params]
    lib = _emulated(monkeypatch, [agg_t, *ps])
    one = cp.epilogue_fwd_cuda(agg_t, *ps, H, True)
    per_row = HC * (agg_t.element_size() * L + 4)
    monkeypatch.setattr(cp, "WIDE_FWD_BYTES", 128 * per_row + 1)
    assert cp.wide_fwd_rows(M, HC, L, 1, agg_t.element_size()) == 128
    lib.calls.clear()
    passes = cp.epilogue_fwd_cuda(agg_t, *ps, H, True)
    one_pass = [("rows", cp.ROW_LN0), ("gemm", cp.EP_H, 0), ("gemm", cp.EP_V, 1),
                ("rows", cp.ROW_LN1)]
    assert lib.calls == one_pass * 3
    assert torch.equal(passes, one)


def test_wide_forward_passes_stay_within_their_budget():
    """wide_fwd_rows: a multiple of the 128-row tile, at most M rounded up
    to it, its tables (zb, h1 in the dtype, p in f32, per run) within
    WIDE_FWD_BYTES unless one tile exceeds them."""
    for M, HC, L, runs, item in ((300, 640, 2, 1, 4), (196_608, 1024, 2, 1, 2),
                                 (158_766, 1024, 2, 2, 4), (1000, 2048, 1, 20, 4)):
        rows = cp.wide_fwd_rows(M, HC, L, runs, item)
        assert rows % cp.WIDE_TR == 0 and rows <= cp.wide_tiles(M) * cp.WIDE_TR
        per_row = runs * HC * (item * L + 4)
        assert rows == cp.WIDE_TR or rows * per_row <= cp.WIDE_FWD_BYTES
