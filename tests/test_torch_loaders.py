"""The port's raw-archive loaders and registry against the JAX package's
on a miniature archive (``allset_tpu_torch.data.miniature``: every real
dataset name, in the real archive's layout): identical arrays for each
loader family and for every name through ``load_dataset``; the npz cache
round-trips; the cornell family's cache key holds the seed, so two seeds
of walmart-trips-100 give different features, each equal to an uncached
JAX load at that seed (the JAX cache key ignores the seed); the CLI runs
a real name from ``--data_root``."""

import os

import numpy as np
import pytest

import allset_tpu.data.loaders as jload
import allset_tpu.data.registry as jreg
import allset_tpu_torch.data.loaders as tload
import allset_tpu_torch.data.registry as treg
from allset_tpu_torch.data.miniature import write_miniature_archive


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    return write_miniature_archive(str(tmp_path_factory.mktemp("archive")))


def _same(got, want):
    for k in ("x", "y", "node", "edge"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (got.num_nodes, got.num_hyperedges) == (want.num_nodes, want.num_hyperedges)


FAMILIES = {
    "LE": lambda m, root: m.load_LE_dataset(root, "zoo"),
    "citation": lambda m, root: m.load_citation_dataset(os.path.join(root, "cocitation"),
                                                        "cora"),
    "yelp": lambda m, root: m.load_yelp_dataset(os.path.join(root, "yelp")),
    "cornell": lambda m, root: m.load_cornell_dataset(root, "walmart-trips", feature_noise=0.5,
                                                      feature_dim=100, seed=3),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loader_family_matches_jax(archive, family):
    _same(FAMILIES[family](tload, archive), FAMILIES[family](jload, archive))


@pytest.mark.parametrize("name", treg.EXISTING_DATASETS)
def test_registry_name_matches_jax(archive, name, tmp_path):
    noise = 1.0 if name in treg.SYNTHETIC_FEATURE_DATASETS else None
    want = jreg.load_dataset(name, root=archive, cache_dir=str(tmp_path / "j"),
                             feature_noise=noise, seed=0)
    got = treg.load_dataset(name, root=archive, cache_dir=str(tmp_path / "t"),
                            feature_noise=noise, seed=0)
    _same(got, want)
    assert got.y.min() == 0 or name not in treg.RELABEL_DATASETS
    # the second load comes from the cache, the same arrays
    _same(treg.load_dataset(name, root=archive, cache_dir=str(tmp_path / "t"),
                            feature_noise=noise, seed=0), want)


def test_cache_round_trip(tmp_path):
    from allset_tpu_torch.data.synthetic import synthetic_hypergraph

    hd = synthetic_hypergraph(num_nodes=20, num_hyperedges=10, num_classes=3, feature_dim=8,
                              seed=1)
    hd.extras["degV"] = np.arange(20, dtype=np.float32)
    p = str(tmp_path / "sub" / "cache.npz")
    treg.save_hyperdata(p, hd)
    back = treg.load_hyperdata(p)
    _same(back, hd)
    np.testing.assert_array_equal(back.extras["degV"], hd.extras["degV"])


def test_cornell_cache_key_holds_the_seed(archive, tmp_path):
    cache = str(tmp_path / "cache")
    loads = [treg.load_dataset("walmart-trips-100", root=archive, cache_dir=cache,
                               feature_noise=1.0, seed=s) for s in (0, 1)]
    assert not np.array_equal(loads[0].x, loads[1].x)
    for s, got in zip((0, 1), loads):
        # each JAX load in a cache of its own: uncached
        want = jreg.load_dataset("walmart-trips-100", root=archive,
                                 cache_dir=str(tmp_path / f"j{s}"), feature_noise=1.0, seed=s)
        _same(got, want)
        # and the cached file of that seed gives it back
        _same(treg.load_dataset("walmart-trips-100", root=archive, cache_dir=cache,
                                feature_noise=1.0, seed=s), want)
    assert len(os.listdir(cache)) == 2


def test_cli_runs_a_real_name(archive, tmp_path):
    from allset_tpu_torch import cli

    res = cli.run(["--device", "cpu", "--dname", "walmart-trips-100", "--data_root", archive,
                   "--cache_dir", str(tmp_path / "cache"), "--runs", "2", "--epochs", "2",
                   "--MLP_hidden", "16", "--Classifier_hidden", "16",
                   "--res_root", str(tmp_path / "res")])
    assert res.metrics.shape == (2, 2, 6) and np.isfinite(res.metrics).all()
    assert os.path.exists(tmp_path / "res" / "walmart-trips-100_noise_1.csv")
