from allset_tpu_torch.graph.batch import Batch, split_masks  # noqa: F401
from allset_tpu_torch.graph.incidence import Direction, Incidence  # noqa: F401
from allset_tpu_torch.graph.transforms import (  # noqa: F401
    HyperData,
    add_self_loops,
    coalesce,
    expand_edge_index,
    norm_construction,
    rand_train_test_idx,
)
