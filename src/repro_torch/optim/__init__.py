from repro_torch.optim.optimizers import SGD, make_optimizer  # noqa: F401
