"""Assembly on the host plan (constant-coefficient box meshes): SIPG
Laplace, linear elasticity and the L2 load vectors."""

from hpdg_tpu_torch.assemble.plan import AssemblyPlan, build_plan  # noqa: F401
from hpdg_tpu_torch.assemble.sipg import assemble_laplace  # noqa: F401
from hpdg_tpu_torch.assemble.rhs import l2_functional  # noqa: F401
from hpdg_tpu_torch.assemble.elasticity import (  # noqa: F401
    assemble_elasticity, l2_functional_vec)
