"""The serving tier of the port (counterpart of src/repro/serve): the
SmartPQ continuous-batching scheduler, the synthetic-decode engine, the
overload controller, the durability layer (write-ahead log and snapshots)
and the supervisor that restarts a durable worker."""

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
from repro_torch.serve.durability import (  # noqa: F401
    DurabilityConfig,
    DurabilityStats,
    DurableStore,
    WriteAheadLog,
)
from repro_torch.serve.supervisor import (  # noqa: F401
    Supervisor,
    SupervisorConfig,
    SupervisorReport,
)
