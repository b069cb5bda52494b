from allset_tpu_torch.train.trainer import (  # noqa: F401
    Results,
    TrainConfig,
    Trainer,
    count_params,
    masked_acc,
    masked_nll,
    run_seeds,
    train_steps,
)
