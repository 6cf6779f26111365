"""SLO-aware admission control & scheduling for the /plan serving path.

The pipeline a request crosses before any LLM cost is paid:

  admission (token bucket, queue-depth/ETA deadline shedding)
    -> fairness (weighted per-tenant fair queuing, EDF within a tenant)
      -> degradation ladder (sustained overload routes /plan to the
         shortlist/heuristic planner; hysteresis restores LLM serving)

Disabled by default (``scheduler.enabled=false``): the server's /plan path
is then byte-identical to the pass-through behavior that existed before
this subsystem. The port's copy of ``mcpx/scheduler/``, with no import of
the reference package.
"""

from mcpx_torch.scheduler.admission import RequestContext, ShedError, TokenBucket
from mcpx_torch.scheduler.degrade import DegradeController
from mcpx_torch.scheduler.fairness import FairQueue
from mcpx_torch.scheduler.locality import locality_order
from mcpx_torch.scheduler.scheduler import Scheduler, Slot

__all__ = [
    "DegradeController",
    "FairQueue",
    "RequestContext",
    "Scheduler",
    "ShedError",
    "Slot",
    "TokenBucket",
    "locality_order",
]
