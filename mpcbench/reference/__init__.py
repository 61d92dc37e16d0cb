"""The benchmark's plain reference: a frozen copy of the port's plain solve
path, with its imports rewritten to this folder.

``types``, ``linalg_small``, ``riccati``, ``ocpqp`` (the plain torch
interior-point and equality-Riccati executors), ``scp`` (the SQP with its
filter line search, plain executor only), the models (``centroidal``,
``srbd_legged``, ``quadruped_kinematics``), the friction cone and the cost
and constraint assembly of the two MPC families (``centroidal_mpc``,
``legged_mpc``). Any dtype, any device; no CUDA graph and no kernel. It
imports nothing of the program, so a change to the program cannot move
the yardstick that ``correct`` is decided by.
"""
