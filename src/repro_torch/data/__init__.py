from repro_torch.data.synthetic import SyntheticClassification  # noqa: F401
from repro_torch.data.pipeline import (  # noqa: F401
    Pipeline, epoch_index_plan, materialize,
)
