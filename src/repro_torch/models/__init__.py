"""The paper's CNN and the model zoo's ported families (SSM so far)."""
from repro_torch.models.cnn import CNN, CNNConfig  # noqa: F401
from repro_torch.models.model import Model, build_model  # noqa: F401
