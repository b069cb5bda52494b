"""Per-dataset tuned AllSetTransformer configs (a copy of
``allset_tpu/train/presets.py``; importing that module would load jax).

The reproduction contract of ``src/run_AllSetTransformer.sh`` (line ranges
per row in SURVEY.md §6 / BASELINE.md): all rows use All_num_layers=1,
MLP_num_layers=2, Classifier_num_layers=1, epochs=500, runs=20, lr=0.001,
wd=0 unless noted.
"""

from __future__ import annotations

from typing import Dict, Optional

# dataset -> (heads, MLP_hidden, Classifier_hidden, lr, wd, feature_noise)
ALLSET_TRANSFORMER_PRESETS: Dict[str, dict] = {
    "cora": dict(heads=4, mlp_hidden=256, classifier_hidden=128),
    "citeseer": dict(heads=8, mlp_hidden=512, classifier_hidden=256),
    "pubmed": dict(heads=8, mlp_hidden=256, classifier_hidden=256),
    "coauthor_cora": dict(heads=8, mlp_hidden=128, classifier_hidden=128),
    "coauthor_dblp": dict(heads=8, mlp_hidden=512, classifier_hidden=256),
    "zoo": dict(heads=1, mlp_hidden=64, classifier_hidden=64, lr=0.01, wd=1e-5),
    "20newsW100": dict(heads=8, mlp_hidden=256, classifier_hidden=256),
    "Mushroom": dict(heads=1, mlp_hidden=128, classifier_hidden=128),
    "NTU2012": dict(heads=1, mlp_hidden=256, classifier_hidden=256),
    "ModelNet40": dict(heads=8, mlp_hidden=512, classifier_hidden=128),
    "yelp": dict(heads=1, mlp_hidden=64, classifier_hidden=64),
    "house-committees-100": dict(
        heads=8, mlp_hidden=512, classifier_hidden=128, feature_noise=1.0
    ),
    "house-committees-100@0.6": dict(
        heads=1, mlp_hidden=512, classifier_hidden=256, feature_noise=0.6
    ),
    "walmart-trips-100": dict(
        heads=8, mlp_hidden=256, classifier_hidden=128, feature_noise=1.0
    ),
    # walmart-shaped synthetic stand-in (data/synthetic.py): same tuned
    # row as walmart-trips-100 so `--dname synthetic-walmart --preset`
    # runs the Table-2 protocol without the raw archive
    "synthetic-walmart": dict(
        heads=8, mlp_hidden=256, classifier_hidden=128, feature_noise=1.0
    ),
    "walmart-trips-100@0.6": dict(
        heads=8, mlp_hidden=256, classifier_hidden=128, feature_noise=0.6
    ),
}

BASE_PRESET = dict(
    all_num_layers=1,
    mlp_num_layers=2,
    classifier_num_layers=1,
    epochs=500,
    runs=20,
    lr=0.001,
    wd=0.0,
)

# Table-2 sweep grids (src/run_all_experiments.sh:20-39)
SWEEP_MLP_HIDDEN = (64, 128, 256, 512)
SWEEP_CLASSIFIER_HIDDEN = (64, 128, 256)
NOISE_SWEEP = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)  # src/run_different_noise.sh


def preset_for(dname: str, noise: Optional[float] = None) -> dict:
    key = dname
    if noise is not None and f"{dname}@{noise}" in ALLSET_TRANSFORMER_PRESETS:
        key = f"{dname}@{noise}"
    out = dict(BASE_PRESET)
    out.update(ALLSET_TRANSFORMER_PRESETS.get(key, {}))
    return out
