"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""
from repro_torch.kernels import ops  # noqa: F401
