from allset_tpu_torch.utils.jax_bridge import params_from_jax  # noqa: F401
