"""Runtime support, ported: fault injection and the restart loop, straggler
speed factors, and the balancer side of elastic scaling (the JAX package's
``repro.runtime`` is the reference)."""
from repro_torch.runtime.elastic import (RankJoin,  # noqa: F401
                                         SurvivorResize, expand_phase,
                                         survivor_resize)
from repro_torch.runtime.fault import (FaultInjector,  # noqa: F401
                                       NodeFailure, RankDeath,
                                       run_with_restarts)
from repro_torch.runtime.straggler import StragglerTracker  # noqa: F401
