"""The paper's CNN and the model zoo's ported families (dense and SSM)."""
from repro_torch.models.cnn import CNN, CNNConfig  # noqa: F401
from repro_torch.models.model import LM, Model, build_model  # noqa: F401
