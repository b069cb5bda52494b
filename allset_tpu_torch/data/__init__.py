from allset_tpu_torch.data.registry import load_dataset  # noqa: F401
from allset_tpu_torch.data.synthetic import (  # noqa: F401
    cornell_like_hypergraph,
    distractor_hypergraph,
    scale_free_hypergraph,
    synthetic_hypergraph,
)
