from allset_tpu_torch.train.trainer import masked_nll, train_steps  # noqa: F401
