"""The ported models and :func:`build_model`, which builds one from its
configuration."""

from allset_tpu_torch.models.cegnn import (CEGAT, CEGCN, CEConfig, GATConv,  # noqa: F401
                                           GCNConv, build_ce)
from allset_tpu_torch.models.hcha import HCHA, HCHAConfig, HypergraphConv  # noqa: F401
from allset_tpu_torch.models.hnhn import HNHN, HNHNConfig, HNHNConv  # noqa: F401
from allset_tpu_torch.models.hypergcn import (HyperGCN, HyperGCNConfig,  # noqa: F401
                                              HyperGCNReapprox, build_hypergcn)
from allset_tpu_torch.models.legacy_hgnn import (LegacyHGNN, LegacyHGNNConfig,  # noqa: F401
                                                 MLPConfig, MLPModel)
from allset_tpu_torch.models.setgnn import SetGNN, SetGNNConfig  # noqa: F401
from allset_tpu_torch.models.unignn import (UniGCNII, UniGCNIIConfig, UniGNN,  # noqa: F401
                                            UniGNNConfig)

MODELS = {
    SetGNNConfig: SetGNN,
    HCHAConfig: HCHA,
    HNHNConfig: HNHN,
    UniGNNConfig: UniGNN,
    UniGCNIIConfig: UniGCNII,
    MLPConfig: MLPModel,
    LegacyHGNNConfig: LegacyHGNN,
    CEConfig: build_ce,
    HyperGCNConfig: build_hypergcn,
}


def build_model(cfg, generator):
    """The model a configuration describes; ``generator`` is one
    torch.Generator, or a list of R for R statistical runs."""
    return MODELS[type(cfg)](cfg, generator)
