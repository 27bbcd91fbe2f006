"""`repro_torch.runtime`: fault draws and elastic restore, the
buffered-async and aggregator-tree round engines, and the multi-tenant
serving engine (`repro.runtime`)."""
from repro_torch.runtime.fault import (  # noqa: F401
    FaultSimulator, StragglerPolicy, FaultInjector,
    participation_vector, counter_uniform, counter_normal,
)
from repro_torch.runtime.elastic import (  # noqa: F401
    reshard_server, cohort_plan, restore_theta_only,
)
from repro_torch.runtime.async_engine import (  # noqa: F401
    AsyncConfig, AsyncRoundEngine,
)
from repro_torch.runtime.serve_engine import (  # noqa: F401
    Completion, Request, ServeEngine,
)
