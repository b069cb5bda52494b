from allset_tpu_torch.models.setgnn import SetGNN, SetGNNConfig  # noqa: F401
