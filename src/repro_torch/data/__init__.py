from repro_torch.data.synthetic import SyntheticClassification  # noqa: F401
from repro_torch.data.pipeline import Pipeline, epoch_index_plan  # noqa: F401
