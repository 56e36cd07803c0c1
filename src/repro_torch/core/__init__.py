"""KAKURENBO core: adaptive sample hiding and the paper's baselines.

Importing the package registers every ported strategy (``make_strategy``).
"""
from repro_torch.core import planops  # noqa: F401
from repro_torch.core.state import (  # noqa: F401
    SampleState, init_sample_state, scatter_observations,
)
from repro_torch.core.selection import (  # noqa: F401
    SELECTION_METHODS, select_hidden, select_hidden_histogram,
    select_hidden_sort,
)
from repro_torch.core.schedule import (  # noqa: F401
    FractionSchedule, LRSchedule, kakurenbo_lr,
)
from repro_torch.core.strategy import (  # noqa: F401
    STRATEGIES, EpochPlan, SampleStrategy, available_strategies,
    make_strategy, register_strategy,
)
from repro_torch.core.kakurenbo import (  # noqa: F401
    KakurenboConfig, KakurenboSampler, KakurenboStrategy,
)
from repro_torch.core.baseline import BaselineStrategy, RandomStrategy  # noqa: F401
from repro_torch.core.iswr import ISWRConfig, ISWRStrategy  # noqa: F401
from repro_torch.core.forget import ForgetConfig, ForgetStrategy  # noqa: F401
from repro_torch.core.selective_backprop import SBConfig, SBStrategy  # noqa: F401
from repro_torch.core.infobatch import (  # noqa: F401
    InfoBatchConfig, InfoBatchStrategy,
)
