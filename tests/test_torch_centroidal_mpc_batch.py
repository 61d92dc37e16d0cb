"""PyTorch port, the centroidal MPC on a leading batch dimension against
``jax.vmap`` of the JAX package's solver, and the f32 kernel backend against
the JAX package's Pallas backend.

Batch: three scenarios with different seeds and gaits, f64, both sides on
``qp_backend='riccati'``; tolerances as in test_torch_centroidal_mpc.py
(1e-6 on forces and trajectories; discrete outputs identical, per element).

f32: the port's default backend ``'riccati_kernel'`` (on the CPU: the plain
versions of the CUDA kernels) against ``'riccati_pallas'`` (the Pallas
kernels in interpret mode) at N=6. Two f32 executors of one algorithm;
ground-reaction forces within 5e-2 N, the JAX package's own bound between
its f32 executors.
"""

import jax.numpy as jnp
import numpy as np
import torch

from cheeta_mpc_tpu import examples as jex
from cheeta_mpc_tpu.mpc import centroidal_mpc as jm
from cheeta_mpc_tpu.ops.ocpqp import IpmSettings as JIpm
from cheeta_mpc_tpu.solvers.scp import ScpSettings as JScp
from cheeta_mpc_tpu_torch import examples as tex
from cheeta_mpc_tpu_torch.convert import (config_from_dict,
                                          scp_settings_from_dict)
from cheeta_mpc_tpu_torch.mpc import centroidal_mpc as tm
from cheeta_mpc_tpu_torch.ops import cuda_ipm_batch, cuda_ipm_riccati
from tests.torch_port_util import (assert_close, assert_qp_data_close,
                                   jax_centroidal_solve, max_err)

N = 6


def _configs(dtype, backend):
    jcfg = jm.CentroidalMpcConfig(
        mass=8.0, num_legs=4, horizon=N, dt=0.01,
        weights=tuple(jex.TEST_WEIGHTS), mu=(0.8,) * 4,
        dtype=jnp.dtype(dtype))
    d = jcfg._asdict()
    d["dtype"] = dtype
    jscp = JScp(iterations=2, ipm=JIpm(iters=10), qp_backend=backend)
    sd = jscp._asdict()
    sd["ipm"] = jscp.ipm._asdict()
    return jcfg, jscp, config_from_dict(d), scp_settings_from_dict(sd)


def _three_scenarios(cfg):
    each = [tex.make_example_inputs(cfg, seed=s, gait=g)
            for s, g in ((1, "trot"), (2, "bound"), (3, "stance"))]
    return tuple(np.stack(parts) for parts in zip(*each))


def test_batch_of_three_matches_vmap():
    jcfg, jscp, tcfg, tscp = _configs("float64", "riccati")
    inputs = _three_scenarios(tcfg)
    rsol, steps, types, rqp = jax_centroidal_solve(jcfg, jscp, inputs,
                                                   batched=True)
    solve = tm.build_centroidal_solver(tcfg, tscp, device="cpu")
    # The first QP: batch-shaped leaves per element; C, D and Q carry no
    # batch dimension in the port (shared by the fleet) and broadcast.
    qp = solve.initial_qp(*inputs)
    assert qp.con.C.dim() == 3 and qp.cost.Q.dim() == 3
    assert qp.dyn.A.shape == (3, N, 33, 33)
    assert_qp_data_close(qp, rqp, 1e-10)

    sol = solve(*inputs)
    assert sol.contact_force.shape == (3, 4, 3, N)
    for name in ("contact_force", "foot_pos", "x_traj", "u_traj"):
        assert_close(getattr(sol, name), getattr(rsol, name), 1e-6, what=name)
    assert_close(sol.merit, rsol.merit, 1e-6, rtol=1e-9)
    assert np.array_equal(sol.step_size.numpy(), np.asarray(steps))
    assert np.array_equal(sol.step_type.numpy(), np.asarray(types))
    assert np.array_equal(sol.convergence.numpy(),
                          np.asarray(rsol.convergence))
    # The scenarios really differ (stance carries all four legs).
    f = sol.contact_force.numpy()
    assert np.count_nonzero(f[2, :, 2, :]) == 4 * N
    assert np.count_nonzero(f[0, :, 2, :]) == 2 * N
    # Element 1 alone gives what the batch gave it.
    one = solve(*(a[1] for a in inputs))
    assert max_err(one.contact_force, sol.contact_force[1]) < 1e-9
    assert torch.equal(one.step_size, sol.step_size[1])


def test_f32_kernel_backend_matches_pallas_backend():
    jcfg, jscp, tcfg, tscp = _configs("float32", "riccati_pallas")
    assert tscp.qp_backend == "riccati_kernel"
    assert tscp == tscp._replace(qp_backend=tm.ScpSettings().qp_backend)
    inputs = tex.make_example_inputs(tcfg)
    rsol, _, _, _ = jax_centroidal_solve(jcfg, jscp, inputs)
    before = (cuda_ipm_riccati.solve_ocp_qp_kernel.launches,
              cuda_ipm_batch.solve_ocp_qp_fleet.launches)
    sol = tm.build_centroidal_solver(tcfg, tscp, device="cpu")(*inputs)
    assert sol.contact_force.dtype == torch.float32
    assert torch.isfinite(sol.contact_force).all()
    err = max_err(sol.contact_force, rsol.contact_force)
    print(f"f32 GRF, port kernel backend (plain) vs Pallas interpret: {err}")
    assert err <= 5e-2
    # On the CPU no kernel is launched, so no counter moves.
    assert before == (cuda_ipm_riccati.solve_ocp_qp_kernel.launches,
                      cuda_ipm_batch.solve_ocp_qp_fleet.launches)
    # Gains come back from the batch-1 path ...
    assert torch.isfinite(sol.gains_K).all()
    # ... and a fleet through the same backend runs the fleet plain version
    # (NaN gains) and agrees with the batch-1 solves.
    many = tuple(np.stack([a, a]) for a in inputs)
    fleet = tm.build_centroidal_solver(tcfg, tscp, device="cpu")(*many)
    assert torch.isnan(fleet.gains_K).all()
    assert max_err(fleet.contact_force[1], sol.contact_force) <= 5e-2
