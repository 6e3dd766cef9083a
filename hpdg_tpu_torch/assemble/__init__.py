"""Assembly on the host plan: SIPG Laplace, linear elasticity, mass and
the right-hand-side functionals, on box meshes and on meshes with
first-class geometry."""

from hpdg_tpu_torch.assemble.plan import AssemblyPlan, build_plan  # noqa: F401
from hpdg_tpu_torch.assemble.sipg import (  # noqa: F401
    assemble_laplace, pullback_diffusion)
from hpdg_tpu_torch.assemble.rhs import (  # noqa: F401
    l2_functional, dirichlet_rhs, neumann_rhs)
from hpdg_tpu_torch.assemble.mass import (  # noqa: F401
    assemble_mass, lumped_mass)
from hpdg_tpu_torch.assemble.elasticity import (  # noqa: F401
    assemble_elasticity, l2_functional_vec)
