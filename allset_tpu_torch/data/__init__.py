from allset_tpu_torch.data.synthetic import (  # noqa: F401
    scale_free_hypergraph,
    synthetic_hypergraph,
)
