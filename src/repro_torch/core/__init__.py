"""KAKURENBO core: adaptive sample hiding and the paper's baselines.

Importing the package registers every ported strategy (``make_strategy``).
The sampler classes each strategy wraps (``KakurenboSampler``,
``ISWRSampler``, ``ForgetSampler``, ``InfoBatchSampler``,
``GradMatchSampler``) and ``SelectiveBackprop`` are exported for direct,
low-level use, as in the reference.  Its ``TrainCarry`` (the ``lax.scan``
carry) has no counterpart: the CUDA-graph engine keeps those fields in
place.
"""
from repro_torch.core import planops  # noqa: F401
from repro_torch.core.planops import strategy_seed  # noqa: F401
from repro_torch.core.state import (  # noqa: F401
    SampleState, init_sample_state, scatter_observations, state_summary,
    with_hidden,
)
from repro_torch.core.selection import (  # noqa: F401
    HIST_BINS, SELECTION_METHODS, histogram_threshold, select_hidden,
    select_hidden_histogram, select_hidden_sort,
)
from repro_torch.core.schedule import (  # noqa: F401
    FractionSchedule, LRSchedule, kakurenbo_lr, linear_scaling_rule,
)
from repro_torch.core.strategy import (  # noqa: F401
    STRATEGIES, EpochPlan, FeatsFn, SampleStrategy, available_strategies,
    make_strategy, register_strategy, rng_state, set_rng_state,
)
from repro_torch.core.kakurenbo import (  # noqa: F401
    KakurenboConfig, KakurenboSampler, KakurenboStrategy,
)
from repro_torch.core.baseline import BaselineStrategy, RandomStrategy  # noqa: F401
from repro_torch.core.iswr import ISWRConfig, ISWRSampler, ISWRStrategy  # noqa: F401
from repro_torch.core.forget import (  # noqa: F401
    ForgetConfig, ForgetSampler, ForgetStrategy,
)
from repro_torch.core.selective_backprop import (  # noqa: F401
    SBConfig, SBStrategy, SelectiveBackprop,
)
from repro_torch.core.infobatch import (  # noqa: F401
    InfoBatchConfig, InfoBatchSampler, InfoBatchStrategy,
)
from repro_torch.core.gradmatch import (  # noqa: F401
    GradMatchConfig, GradMatchSampler, GradMatchStrategy,
)
