"""PyTorch port: utils/info_config.py (a copy, numpy only),
``LeggedMpcConfig.from_task_info`` and ``MpcSettings.from_task_info``
against the JAX package's on the same files.

The reference's own task.info and gait.info are not in the repository, so
the test writes files of their shape with stand-in numbers (every section
the loaders read, comments of both kinds, a matrix with ``scaling``, braces
on their own lines and on the key's line; ``tests/torch_port_util.py``
holds the text). Tolerance 0: parsing is host
code and the configurations are made of Python floats.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheeta_mpc_tpu.mpc import legged_mpc as jl
from cheeta_mpc_tpu.mpc import runtime as jrt
from cheeta_mpc_tpu.utils import info_config as jic
from cheeta_mpc_tpu_torch.mpc import legged_mpc as tl
from cheeta_mpc_tpu_torch.mpc import runtime as trt
from cheeta_mpc_tpu_torch.utils import info_config as tic
from tests.torch_port_util import (GAIT_INFO, Q_DIAG, R_DIAG, TASK_INFO,
                                   write_info_files)


@pytest.fixture()
def files(tmp_path):
    return write_info_files(tmp_path)


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    else:
        assert type(a) is type(b) and np.array_equal(a, b), (a, b)


@pytest.mark.parametrize("text", [TASK_INFO, GAIT_INFO, """
    a 1 ; comment
    b { c 2.5 // comment
        d true }
    e false  f -3e-2  g name
    """], ids=["task", "gait", "basic"])
def test_parse_info_matches(text):
    tree = tic.parse_info(text)
    _same(tree, jic.parse_info(text))
    assert tree  # something was parsed


def test_matrix_and_list_helpers_match(files):
    task, gait = files
    t_tree, j_tree = tic.load_info(task), jic.load_info(task)
    for key in ("Q", "R", "initialState"):
        a, b = tic.as_matrix(t_tree[key]), jic.as_matrix(j_tree[key])
        assert a.shape == b.shape and np.array_equal(a, b)
    assert tic.as_matrix(t_tree["R"])[0, 3] == 0.5  # scaling applied
    assert tic.as_matrix(t_tree["initialState"]).shape == (24,)
    g = tic.load_info(gait)
    assert tic.as_list(g["list"]) == jic.as_list(jic.load_info(gait)["list"])
    with pytest.raises(ValueError, match="not a list entry"):
        tic.as_list(g["trot"])
    with pytest.raises(ValueError, match="not a matrix entry"):
        tic.as_matrix(t_tree["mpc"])


def test_gait_library_matches(files):
    _, gait = files
    port, ref = tic.load_gait_library(gait), jic.load_gait_library(gait)
    assert list(port) == list(ref) == ["stance", "trot", "standing_trot"]
    for name in port:
        assert port[name].switching_times == ref[name].switching_times
        assert port[name].mode_sequence == ref[name].mode_sequence
    assert port["trot"].mode_sequence == [9, 6]


@pytest.mark.parametrize("horizon, cone_mode", [(None, "soft"),
                                                (10, "pyramid")])
def test_legged_config_from_task_info_matches(files, horizon, cone_mode):
    task, _ = files
    port = tl.LeggedMpcConfig.from_task_info(task, horizon=horizon,
                                             cone_mode=cone_mode,
                                             dtype=torch.float64)
    ref = jl.LeggedMpcConfig.from_task_info(task, horizon=horizon,
                                            cone_mode=cone_mode,
                                            dtype=jnp.float64)
    p, r = port._asdict(), ref._asdict()
    assert port.dtype == torch.float64 and ref.dtype == jnp.float64
    del p["dtype"], r["dtype"]
    assert p == r
    assert port.horizon == (67 if horizon is None else horizon)
    assert port.params.integrator == "rk2" and port.params.dt == 0.015
    assert port.q_diag == tuple(Q_DIAG) and port.r_diag == tuple(R_DIAG)
    assert (port.friction_mu, port.barrier_mu, port.barrier_delta,
            port.position_error_gain) == (0.7, 0.2, 4.0, 15.0)
    assert tl.LeggedMpcConfig.from_task_info(task).dtype == torch.float32


def test_mpc_settings_from_task_info_matches(files):
    task, _ = files
    port = trt.MpcSettings.from_task_info(task)
    assert vars(port) == vars(jrt.MpcSettings.from_task_info(task))
    assert port.debug_print and not port.cold_start
    assert (port.time_horizon, port.mpc_desired_frequency) == (1.0, 50.0)
