"""The serving tier of the port (counterpart of src/repro/serve): the
SmartPQ continuous-batching scheduler, the synthetic-decode engine and the
overload controller.  Durability and the supervisor are not ported yet."""

from repro_torch.serve.scheduler import (  # noqa: F401
    Request,
    SchedulerCheckpoint,
    SchedulerStats,
    SmartPQScheduler,
)
from repro_torch.serve.engine import ServeEngine, EngineConfig  # noqa: F401
from repro_torch.serve.overload import (  # noqa: F401
    OverloadConfig,
    OverloadController,
)
