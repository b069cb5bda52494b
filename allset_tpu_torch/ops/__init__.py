from allset_tpu_torch.ops.cuda_pack import pma_pack  # noqa: F401
from allset_tpu_torch.ops.cuda_pma import pma_epilogue  # noqa: F401
from allset_tpu_torch.ops.cuda_segment import segment_sum  # noqa: F401
from allset_tpu_torch.ops.exchange import dir_spmm  # noqa: F401
