"""PyTorch port: the command-line nodes of cli/ against the JAX package's.

- ``gait_command`` and ``pose_command`` turn the same stdin into the same
  commands, the same text and the same bytes on the bus as the JAX
  package's (oracles ``tests/test_cli.py``, ``tests/test_command_bus.py``).
- ``legged_demo --device cpu --horizon 10`` runs to its summary with either
  solver, writes its trajectory, metrics and PNG, and follows the JAX
  package's demo on the same files.
- The two-process ``launch --device cpu``: the port's planning node and
  plant in two processes over the shared-memory bus, with a live gait
  switch that the planner applies (oracle
  ``tests/test_launch.py::test_two_process_launch_with_live_gait_switch``),
  following the JAX package's launcher loop; and where the port's plant
  departs from the JAX launcher's, and why.

The ``.info`` files are the stand-ins of ``tests/torch_port_util.py``.
"""

import io
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from cheeta_mpc_tpu.cli import gait_command as j_gait
from cheeta_mpc_tpu.cli import legged_demo as j_demo
from cheeta_mpc_tpu.cli import pose_command as j_pose
from cheeta_mpc_tpu_torch.cli import gait_command as t_gait
from cheeta_mpc_tpu_torch.cli import legged_demo
from cheeta_mpc_tpu_torch.cli import pose_command as t_pose
from cheeta_mpc_tpu_torch.transport.mpc_mrt import TOPICS, MpcNode
from cheeta_mpc_tpu_torch.transport.shm import ShmMessageBus
from cheeta_mpc_tpu_torch.utils.info_config import load_gait_library
from tests.torch_port_util import launch_loop, write_info_files

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture()
def info(tmp_path):
    return write_info_files(tmp_path)


def _bus_name(tag):
    return f"/cheeta_torch_cli_{tag}_{os.getpid()}_{time.monotonic_ns()}"


def test_gait_command_matches_jax(info):
    _, gait = info
    runs = {}
    for name, mod in (("torch", t_gait), ("jax", j_gait)):
        commands, out = [], io.StringIO()
        mod.run(gait, stdin=io.StringIO("trot\nbogus\n\nSTANDING_TROT\n"),
                stdout=out, on_command=lambda n, tpl, c=commands: c.append(
                    (n, list(tpl.switching_times), list(tpl.mode_sequence))))
        runs[name] = (commands, out.getvalue())
    assert runs["torch"] == runs["jax"]
    commands, text = runs["torch"]
    assert [c[0] for c in commands] == ["trot", "standing_trot"]
    assert "unknown gait 'bogus'" in text


@pytest.mark.parametrize("cmd", [(1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 90.0),
                                 (0.3, -0.4, 0.1, -30.0)])
def test_pose_command_conversion_matches_jax(cmd):
    pose = np.array([0.1, 0.2, 0.3, 0.4])
    (t_t, t_p), (j_t, j_p) = (t_pose.command_to_target(pose, *cmd),
                              j_pose.command_to_target(pose, *cmd))
    assert np.array_equal(t_t, j_t) and np.array_equal(t_p, j_p)


def test_pose_command_node_matches_jax():
    texts = []
    for mod in (t_pose, j_pose):
        out = io.StringIO()
        mod.run(stdin=io.StringIO("1 0 0 0\nnot numbers\n0 1 0 90\n"),
                stdout=out)
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    assert "x=1.00" in texts[0] and "yaw=90.0deg" in texts[0]
    assert "expected 4 numbers" in texts[0]


def test_commands_cross_the_bus_as_the_jax_clis_send_them(info):
    """Each CLI attached to a live bus by name: the planner side drains the
    newest command, and its bytes are those the JAX CLI publishes."""
    _, gait = info
    payloads = {}
    for name, gmod, pmod in (("torch", t_gait, t_pose),
                             ("jax", j_gait, j_pose)):
        bus_name = _bus_name(name)
        bus = ShmMessageBus(TOPICS, bus_name, create=True)
        try:
            got = {"gait": [], "target": []}
            node = MpcNode(bus, solve_fn=lambda obs: None,
                           on_gait_command=lambda n, t: got["gait"].append(
                               (n, list(t.switching_times))),
                           on_target_command=got["target"].append)
            gmod.run(gait, stdin=io.StringIO("bogus\ntrot\nstanding_trot\n"),
                     stdout=io.StringIO(), bus=bus_name)
            pmod.run(stdin=io.StringIO("1.0 0.0 0.0 0.0\n"),
                     stdout=io.StringIO(), bus=bus_name)
            node._poll_commands()  # the solver-synchronized drain
            assert [g[0] for g in got["gait"]] == ["standing_trot"]
            lib = load_gait_library(gait)
            assert got["gait"][0][1] == list(
                lib["standing_trot"].switching_times)
            np.testing.assert_allclose(np.ravel(got["target"][0])[:3],
                                       [0.5, 0.0, 0.0], atol=1e-12)
            payloads[name] = (bus.consume_latest("mpc_mode_schedule"),
                              bus.consume_latest("mpc_target"))
        finally:
            bus.close()
    assert payloads["torch"] == payloads["jax"]


@pytest.mark.parametrize("solver, seconds", [("sqp", 0.3), ("ddp", 0.15)])
def test_legged_demo_runs_to_its_summary(solver, seconds, info, tmp_path,
                                         capsys):
    """The port's demo runs to its summary, and its closed loop (f32, as
    both demos solve) follows the JAX package's demo on the same files:
    states within 1e-5, forces within 1e-3 N (the f32 force tolerance of
    the legged solvers' tests)."""
    task, gait = info
    out = str(tmp_path / f"demo_{solver}")
    png = out + ".png"
    common = ["--horizon", "10", "--solver", solver, "--seconds",
              str(seconds), "--task-info", task, "--gait-info", gait]
    rc = legged_demo.main(common + ["--device", "cpu", "--out", out,
                                    "--plot", png])
    text = capsys.readouterr().out
    assert rc == 0
    assert j_demo.main(common + ["--out", str(tmp_path / "jax")]) == 0
    port, ref = np.load(out + "_traj.npz"), np.load(str(tmp_path / "jax")
                                                    + "_traj.npz")
    for key, tol in (("states", 1e-5), ("feet", 1e-5), ("forces", 1e-3)):
        assert port[key].shape == ref[key].shape
        np.testing.assert_allclose(port[key], ref[key], rtol=0, atol=tol,
                                   err_msg=key)
    np.testing.assert_array_equal(port["times"], ref["times"])
    n_steps = int(round(seconds / 0.015))
    solves = 1 + (n_steps - 1) // 2
    assert f"({solves} solves, {solver} solver, soft cone, cpu)" in text
    traj = np.load(out + "_traj.npz")
    assert traj["states"].shape == (n_steps + 1, 24)
    assert traj["forces"].shape == (n_steps, 4, 3)
    assert np.isfinite(traj["states"]).all()
    metrics = [json.loads(ln) for ln in open(out + "_metrics.jsonl")]
    assert len(metrics) == solves and all("cost" in m for m in metrics)
    assert os.path.getsize(png) > 20_000


def test_two_process_launch_with_live_gait_switch(info, tmp_path):
    """Planner and plant as separate processes over shared memory, the
    port's node on the CPU; a gait command published live mid-run is
    applied by the planner, and the robot stays upright through it. The
    trajectory is the JAX package's launcher loop on the same files (run in
    one process, lock-step, through the JAX wire codec; f32 as the launcher
    solves): states within 1e-5, forces within 1e-3 N."""
    task, gait = info
    out = str(tmp_path / "launch")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "cheeta_mpc_tpu_torch.cli.launch",
         "--device", "cpu", "--seconds", "0.6", "--horizon", "10",
         "--switch-gait", "standing_trot@0.3", "--task-info", task,
         "--gait-info", gait, "--out", out],
        env=env, cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    assert "[mpc] node up (sqp, soft cone, N=10, device cpu)" in proc.stdout
    with open(out + "_summary.json") as f:
        summary = json.load(f)
    assert summary["finite"]
    # The initial policy and one per lock-step tick (every second of 40
    # plant steps): the dummy applies the policy of each observation.
    assert summary["solves"] == 20
    assert summary["policies_received"] >= 20
    assert summary["switched_at"] == pytest.approx(0.3 + 10 * 0.015)
    assert summary["switched_at"] < 0.6  # the plant saw the switch
    assert summary["height_drift_m"] < 0.02
    traj = np.load(out + "_traj.npz")
    assert np.isfinite(traj["states"]).all()
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("[mpc] solves ")]
    assert len(line) == 1
    solves = json.loads(line[0][len("[mpc] solves "):])
    assert solves["solves"] == summary["policies_received"]
    # The planner applied the command at the time the plant switched, and
    # its forces load all four feet after it (the new gait's transition
    # stance), which the trot never does once it has started at 0.3 s.
    assert solves["gaits_applied"] == [["standing_trot",
                                        summary["switched_at"]]]
    times = traj["times"][:-1]
    four = (traj["inputs"][:, 2:12:3] > 1.0).all(axis=1)
    assert four[times >= summary["switched_at"]].any()
    assert not four[(times >= 0.3) & (times < summary["switched_at"])].any()

    ref = launch_loop(
        "cheeta_mpc_tpu", task, gait, horizon=10, seconds=0.6,
        switch=("standing_trot", 0.3),
        handshake_repeats=summary["policies_received"] - summary["solves"])
    assert ref["switched_at"] == summary["switched_at"]
    assert ref["gaits_applied"] == [("standing_trot", ref["switched_at"])]
    np.testing.assert_array_equal(traj["times"], ref["times"])
    np.testing.assert_allclose(traj["states"], ref["states"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(traj["inputs"][:, :12], ref["inputs"][:, :12],
                               rtol=0, atol=1e-3)


def test_the_plant_applies_the_policy_of_its_own_observation():
    """Where the port's launcher departs from the JAX package's, and why.
    The handshake re-publishes the initial observation while the planner's
    first solve runs (here 0.3 s, the others 0.05 s), so the planner
    answers it once more.
    The JAX launcher's plant takes the first policy that arrives after it
    publishes its next observation: that repeat's, made for t = 0, one
    solve stale, and whether it comes first depends on timing. The port's
    plant (``launch.wait_for_policy_at``) drains to the policy of its own
    observation, as the reference's synchronized loop waits for a policy
    at the current time (MRT_ROS_Dummy_Loop.cpp:96-118)."""
    from cheeta_mpc_tpu.transport import mpc_mrt as j_mrt
    from cheeta_mpc_tpu_torch.cli.launch import wait_for_policy_at
    from cheeta_mpc_tpu_torch.mpc.runtime import PolicyData as TPolicy
    from cheeta_mpc_tpu_torch.mpc.runtime import SystemObservation as TObs
    from cheeta_mpc_tpu_torch.transport import mpc_mrt as t_mrt
    from cheeta_mpc_tpu.mpc.runtime import PolicyData as JPolicy
    from cheeta_mpc_tpu.mpc.runtime import SystemObservation as JObs

    def planner(policy_cls):
        def solve(obs):
            time.sleep(0.05 if calls else 0.3)
            calls.append(obs.time)
            return policy_cls(times=obs.time + 0.015 * np.arange(3),
                              x_traj=np.zeros((3, 2)),
                              u_traj=np.zeros((2, 1)), K=None)
        calls = []
        return solve, calls

    applied = {}
    for name, mrt_mod, policy_cls, obs_cls in (
            ("jax", j_mrt, JPolicy, JObs), ("torch", t_mrt, TPolicy, TObs)):
        bus = mrt_mod.make_bus(native=False)
        solve, calls = planner(policy_cls)
        node = mrt_mod.MpcNode(bus, solve)
        node.launch()
        try:
            mrt = mrt_mod.MrtNode(bus)
            assert mrt.reset_mpc(timeout_s=5.0)
            assert mrt.wait_for_initial_policy(
                obs_cls(time=0.0, state=np.zeros(2), input=None, mode=0),
                timeout_s=10.0)
            mrt.set_current_observation(
                obs_cls(time=0.03, state=np.zeros(2), input=None, mode=0))
            if name == "jax":  # cheeta_mpc_tpu/cli/launch.py run_dummy
                seq = bus.wait_for("mpc_policy", mrt._last_policy_seq,
                                   timeout_s=10.0)
                assert seq > mrt._last_policy_seq
                mrt.spin_once()
                mrt.update_policy()
            else:
                assert wait_for_policy_at(mrt, 0.03, timeout_s=10.0)
            applied[name] = mrt.active_policy.times[0]
            assert calls[:2] == [0.0, 0.0]  # the repeat was answered
        finally:
            node.shutdown()
    assert applied == {"jax": 0.0, "torch": 0.03}
