"""The MILP formulations of paper §V (FWMP, its reduced form, COMCP), the
dense simplex and the SOS1 branch and bound that certify CCM-LB's
assignments: host numpy, copied from the JAX package's ``core/milp``."""
from repro_torch.core.milp.bnb import MILPResult, solve_milp  # noqa: F401
from repro_torch.core.milp.comcp import build_comcp  # noqa: F401
from repro_torch.core.milp.fwmp import build_fwmp  # noqa: F401
from repro_torch.core.milp.fwmp_reduced import build_fwmp_reduced  # noqa: F401
from repro_torch.core.milp.lp import LPResult, simplex_solve  # noqa: F401
