"""PyTorch port: transport/{wire,bus,shm,mpc_mrt}.py and the g++-built
buses of native/ against the JAX package's.

- Wire: every encoding of the port is byte-equal to the JAX package's on
  the same message, and each package decodes the other's bytes.
- Buses: the native in-process bus builds, publishes, consumes and waits
  (and so does its pure-Python form), with a torn-read stress test; the
  shared-memory segment of either package is read by the other's facade.
- The threaded MPC/MRT split (oracle ``tests/test_transport.py``) and the
  two-process shared-memory round trip (oracle
  ``tests/test_shm_transport.py``), this one with the port's legged planning
  node in the child process on ``device="cpu"``: every policy that crosses
  the process boundary equals the in-process node's on the same
  observation, after the same float32 wire.
"""

import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from cheeta_mpc_tpu.gait.schedule import ModeSequenceTemplate as JTemplate
from cheeta_mpc_tpu.mpc import runtime as jrt
from cheeta_mpc_tpu.transport import shm as jshm
from cheeta_mpc_tpu.transport import wire as jwire
from cheeta_mpc_tpu_torch.gait.schedule import ModeSequenceTemplate
from cheeta_mpc_tpu_torch.mpc.runtime import PolicyData, SystemObservation
from cheeta_mpc_tpu_torch.native import build
from cheeta_mpc_tpu_torch.transport import shm as tshm
from cheeta_mpc_tpu_torch.transport import wire as twire
from cheeta_mpc_tpu_torch.transport.bus import MessageBus
from cheeta_mpc_tpu_torch.transport.mpc_mrt import (TOPICS, MpcNode, MrtNode,
                                                    make_bus)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _unique_name(tag):
    return (f"/cheeta_torch_test_{tag}_{os.getpid()}_"
            f"{time.monotonic_ns() % 100000}")


# -- wire ---------------------------------------------------------------------

def _messages(rng):
    """The same messages built from both packages' types."""
    state, inp = rng.normal(size=24), rng.normal(size=24)
    times = 0.3 + 0.015 * np.arange(11)
    x, u, K = (rng.normal(size=(11, 24)), rng.normal(size=(10, 24)),
               rng.normal(size=(10, 24, 24)))
    st, modes = [0.0, 0.35, 0.7], [9, 6]
    return [
        ("observation",
         SystemObservation(time=1.25, state=state, input=inp, mode=9),
         jrt.SystemObservation(time=1.25, state=state, input=inp, mode=9)),
        ("observation_no_input",
         SystemObservation(time=0.5, state=state, mode=15),
         jrt.SystemObservation(time=0.5, state=state, mode=15)),
        ("policy", PolicyData(times=times, x_traj=x, u_traj=u, K=K),
         jrt.PolicyData(times=times, x_traj=x, u_traj=u, K=K)),
        ("policy_no_K", PolicyData(times=times, x_traj=x, u_traj=u),
         jrt.PolicyData(times=times, x_traj=x, u_traj=u)),
        ("gait", ("standing_trot", ModeSequenceTemplate(st, modes)),
         ("standing_trot", JTemplate(st, modes))),
        ("target", np.array([0.25, 0.0, 0.1]), np.array([0.25, 0.0, 0.1])),
        ("target_matrix", np.arange(12.0).reshape(3, 4),
         np.arange(12.0).reshape(3, 4)),
    ]


_CODECS = {
    "observation": ("encode_observation", "decode_observation"),
    "policy": ("encode_policy", "decode_policy"),
    "gait": ("encode_gait_command", "decode_gait_command"),
    "target": ("encode_target_command", "decode_target_command"),
}


def _codec(kind, module):
    enc, dec = _CODECS[kind.split("_")[0]]
    return getattr(module, enc), getattr(module, dec)


def _fields(msg):
    """A decoded message as a dict of numpy arrays / scalars."""
    if isinstance(msg, tuple):  # gait command
        name, tpl = msg
        return {"name": name, "st": np.asarray(tpl.switching_times),
                "modes": np.asarray(tpl.mode_sequence)}
    if isinstance(msg, np.ndarray):
        return {"target": msg}
    keys = ("time", "state", "input", "mode") if hasattr(msg, "mode") \
        else ("times", "x_traj", "u_traj", "K", "P", "p")
    return {k: getattr(msg, k) for k in keys}


def _same_fields(a, b):
    fa, fb = _fields(a), _fields(b)
    assert list(fa) == list(fb)
    for k in fa:
        if fa[k] is None or fb[k] is None:
            assert fa[k] is None and fb[k] is None, k
        else:
            assert np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])), k


@pytest.mark.parametrize("kind", [m[0] for m in _messages(
    np.random.default_rng(0))])
def test_wire_bytes_equal_the_jax_packages_both_ways(kind):
    port_msg, jax_msg = {m[0]: m[1:] for m in _messages(
        np.random.default_rng(0))}[kind]
    t_enc, t_dec = _codec(kind, twire)
    j_enc, j_dec = _codec(kind, jwire)
    if kind == "gait":
        t_bytes, j_bytes = t_enc(*port_msg), j_enc(*jax_msg)
    else:
        t_bytes, j_bytes = t_enc(port_msg), j_enc(jax_msg)
    assert isinstance(t_bytes, bytes) and t_bytes == j_bytes
    # Each package decodes the other's bytes into what it decodes its own.
    _same_fields(t_dec(j_bytes), j_dec(j_bytes))
    _same_fields(t_dec(j_bytes), t_dec(t_bytes))
    _same_fields(j_dec(t_bytes), t_dec(t_bytes))


def test_wire_round_trip_narrows_to_float32():
    """The reference's float32 wire: times stay f64, the rest is f32."""
    rng = np.random.default_rng(1)
    pol = PolicyData(times=np.arange(11.0) * 0.015,
                     x_traj=rng.normal(size=(11, 24)),
                     u_traj=rng.normal(size=(10, 24)),
                     K=rng.normal(size=(10, 24, 24)))
    out = twire.decode_policy(twire.encode_policy(pol))
    assert np.array_equal(out.times, pol.times)
    for k in ("x_traj", "u_traj", "K"):
        a = getattr(pol, k)
        assert np.array_equal(getattr(out, k),
                              a.astype(np.float32).astype(np.float64))
    obs = twire.decode_observation(twire.encode_observation(
        SystemObservation(time=1.25, state=np.arange(24.0) / 3, mode=9)))
    assert obs.time == 1.25 and obs.mode == 9 and obs.input is None
    assert np.array_equal(obs.state, (np.arange(24.0) / 3).astype(
        np.float32).astype(np.float64))


# -- buses ------------------------------------------------------------------

def test_native_buses_build_into_the_package_and_load():
    lib = build.load_policy_bus()
    assert lib is build.load_policy_bus()  # loaded once per process
    shm_lib = build.load_shm_bus()
    built = sorted(p.name for p in build.BUILD_DIR.glob("lib*bus-*.so"))
    assert any(n.startswith("libpolicybus-") for n in built)
    assert any(n.startswith("libshmbus-") for n in built)
    assert shm_lib.shm_bus_capacity.restype is not None


def test_failed_bus_build_raises_with_the_compiler_output(tmp_path,
                                                          monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(build.NativeBuildError, match="g\\+\\+ failed for "
                       "bad.cpp:(.|\\n)*error"):
        build._build_host_library(bad, "libbad")
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize("native", [True, False])
def test_bus_publish_consume(native):
    bus = MessageBus(["a", "b"], native=native)
    assert bus.is_native == native
    try:
        assert bus.consume_latest("a") == (0, None)
        s1 = bus.publish("a", b"hello")
        s2 = bus.publish("a", b"world!")
        assert s2 == s1 + 1
        assert bus.consume_latest("a") == (s2, b"world!")  # latest wins
        assert bus.consume_latest("b") == (0, None)  # independent topics
    finally:
        bus.close()


@pytest.mark.parametrize("native", [True, False])
def test_bus_wait(native):
    bus = MessageBus(["t"], native=native)

    def later():
        time.sleep(0.05)
        bus.publish("t", b"x")

    th = threading.Thread(target=later)
    th.start()
    try:
        t0 = time.monotonic()
        assert bus.wait_for("t", 0, timeout_s=2.0) == 1
        assert time.monotonic() - t0 < 1.0
        assert bus.wait_for("t", 5, timeout_s=0.05) <= 5  # timeout path
    finally:
        th.join(timeout=5.0)
        assert not th.is_alive()
        bus.close()


def test_native_bus_stress_torn_reads():
    """A publisher and a reader thread, a short switch interval: every read
    is one whole message."""
    bus = MessageBus(["t"], native=True)
    n_msgs = 2000
    payloads = [bytes([i % 256]) * 256 for i in range(n_msgs)]
    bad = []

    def writer():
        for p in payloads:
            bus.publish("t", p)

    def reader():
        for _ in range(4000):
            _, payload = bus.consume_latest("t")
            if payload is not None and len(set(payload)) != 1:
                bad.append(payload)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader),
                   threading.Thread(target=writer)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30.0)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not bad, f"torn reads detected: {len(bad)}"
    assert bus.seq("t") == n_msgs
    bus.close()


@pytest.mark.parametrize("creator", ["jax", "torch"])
def test_shm_segments_are_shared_between_the_packages(creator):
    """One package creates the segment, the other attaches by name: the
    layout is the one C++ source's, so messages cross in both directions."""
    name = _unique_name(f"x{creator}")
    own, other = (jshm, tshm) if creator == "jax" else (tshm, jshm)
    with own.ShmMessageBus(TOPICS, name, create=True,
                           capacity=4096) as server:
        with other.ShmMessageBus(TOPICS, name) as client:
            assert server.publish("mpc_policy", b"hello") == 1
            assert client.consume_latest("mpc_policy") == (1, b"hello")
            assert client.publish("mpc_observation", b"obs") == 1
            assert server.wait_for("mpc_observation", 0, 1.0) == 1
            assert server.consume_latest("mpc_observation") == (1, b"obs")


# -- the MPC/MRT split -------------------------------------------------------

def test_reset_immediately_after_launch():
    """A reset published right after launch() (before the spin thread's
    first poll) is still acked (the JAX package's regression test)."""
    def solve_fn(obs):
        return PolicyData(times=obs.time + 0.1 * np.arange(2),
                          x_traj=np.zeros((2, 2)), u_traj=np.zeros((1, 1)))

    for _ in range(50):
        bus = make_bus(native=True)
        mpc = MpcNode(bus, solve_fn)
        mrt = MrtNode(bus)
        mpc.launch()
        try:
            assert mrt.reset_mpc(timeout_s=5.0)
        finally:
            mpc.shutdown()
            bus.close()


def test_threaded_mpc_mrt_split():
    """MRT handshake -> MPC solves in its own thread -> MRT consumes
    policies; a toy double integrator regulated closed-loop."""
    A = np.array([[1.0, 0.1], [0.0, 1.0]])
    B = np.array([[0.0], [0.1]])
    K = np.array([[-0.8, -1.2]])

    def solve_fn(obs):
        xs, us = [np.asarray(obs.state)], []
        for _ in range(10):
            u = K @ xs[-1]
            us.append(u)
            xs.append(A @ xs[-1] + B @ u)
        return PolicyData(times=obs.time + 0.1 * np.arange(11),
                          x_traj=np.stack(xs), u_traj=np.stack(us),
                          K=np.tile(K[None], (10, 1, 1)))

    bus = make_bus(native=True)
    mpc = MpcNode(bus, solve_fn)
    mrt = MrtNode(bus)
    mpc.launch()
    try:
        assert mrt.reset_mpc(timeout_s=5.0)
        x = np.array([1.0, 0.0])
        t = 0.0
        assert mrt.wait_for_initial_policy(
            SystemObservation(time=t, state=x), timeout_s=10.0)
        for _ in range(80):
            u = mrt.evaluate_policy(t, x)
            x = A @ x + B @ u
            t += 0.1
            mrt.set_current_observation(SystemObservation(time=t, state=x))
            bus.wait_for("mpc_policy", mrt._last_policy_seq, timeout_s=0.2)
            if mrt.spin_once():
                mrt.update_policy()
        assert np.linalg.norm(x) < 0.05, f"not regulated: {x}"
        assert mpc.solve_count > 10
    finally:
        mpc.shutdown()
        bus.close()


# The child: the port's legged planning node (horizon 10, stand-in weights,
# f64, soft cone) behind an MpcNode on the shared-memory bus, on the CPU.
_NODE_SETUP = r"""
import numpy as np
import torch

from cheeta_mpc_tpu_torch.examples import LEGGED_TEST_WEIGHTS
from cheeta_mpc_tpu_torch.gait.schedule import GaitSchedule, trot_template
from cheeta_mpc_tpu_torch.mpc.legged_mpc import LeggedMpcConfig
from cheeta_mpc_tpu_torch.mpc.legged_node import (LeggedPlannerAssembly,
                                                  default_stance_state)


def make_node():
    cfg = LeggedMpcConfig(horizon=10, cone_mode="soft", dtype=torch.float64,
                          **LEGGED_TEST_WEIGHTS)
    gait = GaitSchedule.stance(trot_template(0.7), t0=0.0)
    gait.phase_transition_stance_time = 0.0
    gait.insert_template(trot_template(0.7), insert_time=0.05)
    x0 = default_stance_state(cfg)
    return LeggedPlannerAssembly(cfg, gait, x0, np.array([0.25, 0.0, 0.0]),
                                 device="cpu"), x0
"""

_NODE_CHILD = _NODE_SETUP + r"""
import sys
import time

from cheeta_mpc_tpu_torch.transport.mpc_mrt import TOPICS, MpcNode
from cheeta_mpc_tpu_torch.transport.shm import ShmMessageBus

name, ready_path = sys.argv[1], sys.argv[2]
bus = ShmMessageBus(TOPICS, name)
node, _ = make_node()
mpc = MpcNode(bus, node.solve_fn)
mpc.launch()
with open(ready_path, "w") as f:
    f.write("ready")
time.sleep(120.0)  # the parent terminates us well before this
"""


def test_two_process_round_trip_with_the_ports_node(tmp_path):
    """The port's planning node in a child process on the shared-memory
    bus: reset handshake, initial policy, then lock-step observations; every
    policy that arrives equals the in-process node's on the same (float32
    wire) observation, through the same wire."""
    name = _unique_name("node")
    ready = tmp_path / "ready"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    bus = tshm.ShmMessageBus(TOPICS, name, create=True)
    child = subprocess.Popen(
        [sys.executable, "-c", _NODE_CHILD, name, str(ready)], env=env,
        cwd=str(ROOT))
    try:
        deadline = time.monotonic() + 120.0
        while not ready.exists():
            assert child.poll() is None, "MPC child process died"
            assert time.monotonic() < deadline, "MPC child never came up"
            time.sleep(0.02)
        scope = {}
        exec(_NODE_SETUP, scope)
        local, x0 = scope["make_node"]()
        mrt = MrtNode(bus)
        assert mrt.reset_mpc(timeout_s=10.0)
        rng = np.random.default_rng(0)
        for k in range(4):
            # One observation per tick, answered before the next (the
            # synchronized mode; the handshake's repeated observations would
            # make the node solve t = 0 more than once).
            state = x0 + 1e-3 * k * rng.standard_normal(24)
            obs = SystemObservation(time=0.03 * k, state=state, input=None,
                                    mode=0)
            mrt.set_current_observation(obs)
            seq = bus.wait_for("mpc_policy", mrt._last_policy_seq,
                               timeout_s=60.0)
            assert seq > mrt._last_policy_seq, f"no policy for tick {k}"
            assert mrt.spin_once() and mrt.update_policy()
            got = mrt.active_policy
            wire_obs = twire.decode_observation(
                twire.encode_observation(obs))
            want = twire.decode_policy(twire.encode_policy(
                local.solve_fn(wire_obs)))
            for field in ("times", "x_traj", "u_traj", "K"):
                a, b = getattr(got, field), getattr(want, field)
                scale = max(1.0, float(np.abs(b).max()))
                assert np.abs(a - b).max() <= 1e-6 * scale, (k, field)
    finally:
        child.terminate()
        child.wait(timeout=10.0)
        bus.close()
