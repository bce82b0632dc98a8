"""The paper's application (§VI), ported: the MoM assembly problem, task
execution on the card, wave-based homing and the A/B/C comparison (the JAX
package's ``repro.assembly`` is the reference)."""
from repro_torch.assembly.driver import (AssemblyRun,  # noqa: F401
                                         balance_assembly,
                                         plan_assembly_homing,
                                         run_assembly_comparison)
from repro_torch.assembly.problem import (AssemblyProblem,  # noqa: F401
                                          build_problem)
