"""cheeta_mpc_tpu_torch — the PyTorch/CUDA port of ``cheeta_mpc_tpu``.

Same sub-package and module names as the JAX package, so every module's
counterpart is found by name; PyTorch idiom inside: dataclasses of tensors in
place of pytrees, a written-out leading batch dimension in place of ``vmap``,
eager execution in place of ``jit``, and hand-written CUDA kernels
(``csrc/``, built by ``native/build.py`` at first launch) in place of the
Pallas kernels.

Ported so far — the centroidal MPC main path:

- ``core.types``            problem/solution containers
- ``ops.linalg_small``      SPD inverse of the torch executor
- ``ops.riccati``           Riccati recursions (with and without equalities)
- ``ops.ocpqp``             Mehrotra predictor-corrector IPM, torch executor
- ``ops.cuda_ipm_riccati``  the whole IPM of one problem as one CUDA kernel
- ``ops.cuda_ipm_batch``    the same kernel over a batch (one block/problem)
- ``models.centroidal``     centroidal dynamics with closed-form Jacobians
- ``solvers.scp``           SQP with the parallel-ladder filter line search
- ``mpc.centroidal_mpc``    the centroidal MPC and its ``CentroidalMPC`` facade
- ``examples``              scenario generators (numpy)
- ``convert``               numpy/dict -> port objects, for cross-package tests

Entry points take ``device=`` and default to ``"cuda"``; they raise when no
card is present instead of carrying on on the CPU. This package imports
``torch`` and ``numpy`` only — never ``jax``, ``flax`` or ``cheeta_mpc_tpu``.
"""

__version__ = "0.1.0"
