from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticClassification, SyntheticLM,
)
from repro_torch.data.pipeline import (  # noqa: F401
    Pipeline, epoch_index_plan, materialize, worker_slice,
)
