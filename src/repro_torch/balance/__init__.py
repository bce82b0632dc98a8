"""The three planners that run CCM-LB inside an ML stack: MoE expert
placement, pipeline stage splitting and data-parallel sequence packing
(the JAX package's ``repro.balance`` is the reference)."""
from repro_torch.balance.expert_placement import (PlacementPlan,  # noqa: F401
                                                  ServingPlan,
                                                  apply_expert_permutation,
                                                  phase_from_router_stats,
                                                  plan_expert_placement,
                                                  plan_expert_placement_sequence)
from repro_torch.balance.pipeline_stages import (  # noqa: F401
    plan_pipeline_stages, plan_pipeline_stages_schedule)
from repro_torch.balance.seqpack import (rebalance_sequences,  # noqa: F401
                                         rebalance_sequences_stream)
