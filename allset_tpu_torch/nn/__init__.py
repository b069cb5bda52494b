from allset_tpu_torch.nn.modules import (  # noqa: F401
    MLP,
    PMA,
    HalfNLHconv,
    NormLayer,
    TorchDense,
)
