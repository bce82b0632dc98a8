"""The CCM work model and the CCM-LB synchronous balancer, ported: the
problem, the CCM state and scalar evaluator, the vectorized engine, the
sync driver with its speculative-scan stage 2, and the fleet mode (the JAX
package's ``repro.core`` is the reference)."""
from repro_torch.core.ccm import (CCMState, ExchangeEval,  # noqa: F401
                                  effective_mem_cap, exchange_eval)
from repro_torch.core.ccmlb import (CCMLBResult, ProtocolStats,  # noqa: F401
                                    ccm_lb)
from repro_torch.core.csr import CSR, PhaseCSR, rank_segments  # noqa: F401
from repro_torch.core.fleet import ccm_lb_many  # noqa: F401
from repro_torch.core.engine import (ExchangeEvent, PhaseEngine,  # noqa: F401
                                     SummaryTables, batch_peer_diffs,
                                     build_summary_tables)
from repro_torch.core.problem import (CCMParams, Phase,  # noqa: F401
                                      initial_assignment, random_phase,
                                      scaling_phase)
