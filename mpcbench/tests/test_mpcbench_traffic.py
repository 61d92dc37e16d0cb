"""The frozen traffic helpers equal the port's scenario code that they were
copied from (``examples.make_example_inputs``, ``gait_table``,
``default_stance_state`` and the trot of ``make_legged_example_inputs``)."""

import json
from pathlib import Path

import numpy as np
import pytest

from cheeta_mpc_tpu_torch import examples
from mpcbench.traffic._frozen import centroidal_inputs, legged_inputs

ROOT = Path(__file__).resolve().parents[2]
CEN = json.loads((ROOT / "mpcbench/configs/centroidal_n10.json").read_text())
LEG = json.loads((ROOT / "mpcbench/configs/legged_soft_n67.json")
                 .read_text())


@pytest.mark.parametrize("gait", centroidal_inputs.GAITS)
@pytest.mark.parametrize("phase", [0, 3])
def test_gait_table(gait, phase):
    np.testing.assert_array_equal(
        centroidal_inputs.gait_table(gait, 10, phase),
        examples.gait_table(gait, 10, phase=phase))


def test_packed_inputs_equal_make_example_inputs():
    from cheeta_mpc_tpu_torch.mpc.centroidal_mpc import CentroidalMpcConfig
    cfg = CentroidalMpcConfig(horizon=10)
    params = dict(vx_mean=0.1, vx_std=0.05, z_mean=0.15, z_std=0.01,
                  feet_std=0.01)
    tables = np.stack([examples.trot_table(10)] * 6)
    got = centroidal_inputs.packed_inputs(
        CEN, params, np.random.default_rng(4), tables)
    want = examples.make_example_inputs(cfg, batch=6, seed=4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-15)


def test_legged_trot_equals_the_ports_scenario():
    from cheeta_mpc_tpu_torch.mpc.legged_mpc import LeggedMpcConfig
    cfg = LeggedMpcConfig(horizon=67)
    np.testing.assert_allclose(legged_inputs.default_stance_state(
        LEG["model"]), examples.default_stance_state(cfg), atol=1e-15)
    ex = examples.make_legged_example_inputs(cfg, batch=4, seed=3)
    phase = np.random.default_rng(3)
    phase.standard_normal(4)
    phase = phase.uniform(0.0, 0.7, 4)
    phase[0] = 0.0
    sampler = legged_inputs.TrotSampler(LEG, 0.7)
    for i in range(4):
        enable, zp, zv = sampler.sample(phase[i])
        np.testing.assert_array_equal(enable, ex.enable[i])
        np.testing.assert_allclose(zp, ex.z_pos[i], atol=1e-12)
        np.testing.assert_allclose(zv, ex.z_vel[i], atol=1e-12)
