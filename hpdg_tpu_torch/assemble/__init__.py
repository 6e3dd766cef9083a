"""SIPG assembly on the host plan (constant-coefficient box meshes)."""

from hpdg_tpu_torch.assemble.plan import AssemblyPlan, build_plan  # noqa: F401
from hpdg_tpu_torch.assemble.sipg import assemble_laplace  # noqa: F401
from hpdg_tpu_torch.assemble.rhs import l2_functional  # noqa: F401
