from repro_torch.train.trainer import EpochStats, TrainConfig, Trainer  # noqa: F401
