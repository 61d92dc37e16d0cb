"""PyTorch port: gait/receiver.py (a copy, numpy only) against the JAX
package's GaitReceiver on the same commands.

Its timing contract: a command buffered between solves is applied by the
next ``pre_solver_run`` at that solve's final time, so the running horizon
is never changed mid-plan; a newer command replaces a buffered one; the
hook applies nothing when nothing is buffered. Both receivers drive their
own package's GaitSchedule through the same sequence, and the mode
schedules they leave must be equal exactly (event times and modes are
host-side floats and ints)."""

import numpy as np
import pytest

from cheeta_mpc_tpu.gait import receiver as jrec
from cheeta_mpc_tpu.gait import schedule as jsch
from cheeta_mpc_tpu_torch.gait import GaitReceiver
from cheeta_mpc_tpu_torch.gait import receiver as trec
from cheeta_mpc_tpu_torch.gait import schedule as tsch

# (solve time, commands that arrive just before it)
SEQUENCES = {
    "one_trot": [(0.0, []), (0.3, [("trot", 0.6)]), (0.6, [])],
    "replaced": [(0.0, [("trot", 0.6), ("stance", 0.5)]), (0.5, []),
                 (0.9, [("trot", 0.7)]), (1.4, [])],
    "every_solve": [(0.1 * k, [("trot", 0.5 + 0.05 * k)]) for k in range(6)],
}


def _run(sch, rec, sequence, horizon=1.0):
    gs = sch.GaitSchedule.stance(sch.trot_template(0.6), t0=0.0)
    gs.phase_transition_stance_time = 0.05
    hook_log = []
    receiver = rec.GaitReceiver(
        gs, on_applied=lambda name, t: hook_log.append((name, t)))
    applied = []
    for t, commands in sequence:
        for name, cycle in commands:
            template = (sch.trot_template(cycle) if name == "trot"
                        else sch.stance_template(cycle))
            receiver.on_command(name, template)
        applied.append(receiver.pre_solver_run(t, t + horizon))
    ms = gs.get_mode_schedule(0.0, 5.0)
    flags = [ms.contact_flags_at(t) for t in np.linspace(0.0, 4.9, 50)]
    return (applied, receiver.applied, hook_log, list(ms.event_times),
            list(ms.mode_sequence), np.asarray(flags))


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_receiver_matches_jax(name):
    port = _run(tsch, trec, SEQUENCES[name])
    ref = _run(jsch, jrec, SEQUENCES[name])
    for a, b in zip(port[:-1], ref[:-1]):
        assert a == b
    assert np.array_equal(port[-1], ref[-1])


def test_applies_at_the_final_time():
    gs = tsch.GaitSchedule.stance(tsch.trot_template(0.6), t0=0.0)
    gs.phase_transition_stance_time = 0.0
    rec = GaitReceiver(gs)
    assert not rec.pre_solver_run(0.0, 1.0)
    rec.on_command("trot", tsch.trot_template(0.6))
    assert rec.pre_solver_run(0.3, 1.3)
    assert not rec.pre_solver_run(0.4, 1.4)  # applied once
    assert rec.applied == [("trot", 1.3)]
    ms = gs.get_mode_schedule(0.0, 3.0)
    assert ms.contact_flags_at(1.29).sum() == 4  # stance before final time
    assert ms.contact_flags_at(1.4).sum() == 2  # trot after it
