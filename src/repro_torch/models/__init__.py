"""The paper's CNN (the model zoo comes in later slices)."""
from repro_torch.models.cnn import CNN, CNNConfig  # noqa: F401
