from allset_tpu_torch.nn.modules import (  # noqa: F401
    BatchNorm,
    MLP,
    PMA,
    HalfNLHconv,
    NormLayer,
    TorchDense,
)
