"""hpdg_tpu_torch — the PyTorch/CUDA port of ``hpdg_tpu``.

The 3D SIPG hp-multigrid solve of ``hpdg_tpu`` on one NVIDIA Hopper
card: host-side setup in numpy (quadrature, bases, meshes, plans), the
multigrid cycle in plain PyTorch, and the uniform-lattice SIPG stencil
apply as a hand-written CUDA kernel (``ops.uniform_stencil``).  Module
paths mirror ``hpdg_tpu`` so that each port module sits beside its
reference; public functions keep the reference's data layout (bucket
dicts ``{p: Tensor[n_p, (p+1)^d]}``, block-sparse values
``{(pr, pc): Tensor[nnz, br, bc]}``).

This package never imports JAX or ``hpdg_tpu``.
"""

import torch as _torch

# Full IEEE f32 in every matrix product.  TF32 keeps ~10 mantissa bits;
# reduced-precision passes wrecked the multigrid contraction of the
# reference (rate 0.41 -> 0.78 at "high" precision, divergence at
# "default"), so the port pins both flags, the counterpart of
# ``jax_default_matmul_precision = "highest"`` in ``hpdg_tpu``.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
