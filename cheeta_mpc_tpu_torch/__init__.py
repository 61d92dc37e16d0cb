"""cheeta_mpc_tpu_torch — the PyTorch/CUDA port of ``cheeta_mpc_tpu``.

Same sub-package and module names as the JAX package, so every module's
counterpart is found by name; PyTorch idiom inside: dataclasses of tensors in
place of pytrees, a written-out leading batch dimension in place of ``vmap``,
one CUDA graph per call signature in place of ``jit``, and hand-written
CUDA kernels (``csrc/``, built by ``native/build.py`` at first launch) in
place of the Pallas kernels.

Ported: everything the JAX package does — the centroidal MPC main path,
the legged SRBD MPC, the real-time planning path on top of them, the
deployed runtime around it, the convex SRB MPC, the second equality mode,
the condensed backend, the scenario mesh, and the device timing with the
work counts:

- ``core.types``            problem/solution containers
- ``ops.linalg_small``      SPD inverse of the torch executor
- ``ops.riccati``           Riccati recursions (with and without equalities)
                            and ``fold_terminal_equality``
- ``ops.ocpqp``             Mehrotra predictor-corrector IPM, torch executor
- ``ops.projection``        null-space projection of stage equalities
                            (``eq_mode='projected'``)
- ``ops.condensed``         states eliminated, dense IPM in the inputs
                            (``qp_backend='condensed'``, plain torch)
- ``ops.cuda_ipm_riccati``  the whole IPM of one problem as one CUDA kernel
- ``ops.cuda_ipm_batch``    the same kernel over a batch (one block/problem,
                            stage equalities and C/D per problem allowed),
                            and the dispatch over all four kernels
- ``ops.cuda_eq_riccati``   the exact equality-constrained Riccati solve of
                            one problem as one CUDA kernel
- ``ops.cuda_eq_batch``     the same kernel over a batch
- ``models.centroidal``     centroidal dynamics with closed-form Jacobians
- ``models.srb``, ``mpc.convex_mpc``
                            the single-rigid-body model and the convex SRB MPC
                            (one QP per solve, one CUDA graph per signature)
- ``models.quadruped_kinematics``, ``models.srbd_legged``
                            closed-form leg kinematics, the SRBD step and its
                            forward-mode Jacobians
- ``solvers.scp``           SQP with the parallel-ladder filter line search
- ``solvers.discretization``, ``gait``
                            event-aligned grids, mode schedules, swing planner
                            (numpy)
- ``mpc.centroidal_mpc``    the centroidal MPC, its ``CentroidalMPC`` facade
                            and the n-tick receding-horizon loop
- ``mpc.friction_cone``, ``mpc.ee_constraint``, ``mpc.legged_mpc``
                            soft and pyramid friction cones, end-effector
                            constraint forms, the legged MPC
- ``mpc.legged_node``       the legged planning node (gait, swing, grid, warm
                            start and commands behind one ``solve_fn``), SQP
                            or DDP
- ``solvers.ddp``, ``mpc.legged_ddp``
                            Gauss-Newton DDP (plain torch ops, as the JAX
                            package's has no kernel) and the legged DDP task
- ``transport``, ``native``  wire format, in-process and shared-memory buses
                            (C++ built with g++ at first use), MPC/MRT nodes
- ``cli``, ``viz``          the demo, the two-process launch, the command
                            terminals; CoP, support polygon, PNG rendering
- ``mpc.runtime``, ``mpc.loopshaping``, ``mpc.solver_observer``,
  ``gait.receiver``, ``utils.info_config``, ``utils.timing``
                            the MPC/MRT runtime, config files and timers
                            (numpy copies)
- ``utils.cuda_graph``      ``graphed``: one CUDA graph per call signature
- ``utils.device_timing``   device seconds per call by the slope over chained
                            CUDA-graph replays (``device_time_per_call``),
                            the JAX package's work counts of a solve (for
                            ``mfu_pct``) and the kernels' own (for bounds):

                              solve = build_legged_solver(cfg)  # eager
                              args = tuple(torch.as_tensor(a, device="cuda")
                                           for a in inputs)
                              seconds = device_time_per_call(solve, args)
- ``parallel.mesh``         scenario batches over devices and processes
                            (``torch.distributed``: gloo on the CPU, nccl on
                            the cards)
- ``examples``              scenario generators (numpy)
- ``convert``               numpy/dict -> port objects, for cross-package tests

The port's benchmark is ``mpcbench/`` with ``BENCHMARK.json``, outside the
package; ``chip_smoke.py`` is the card's correctness gate.

Entry points take ``device=`` and default to ``"cuda"``; they raise when no
card is present instead of carrying on on the CPU. This package imports
``torch`` and ``numpy`` only — never ``jax``, ``flax`` or ``cheeta_mpc_tpu``.
"""

__version__ = "0.1.0"
