"""The centroidal MPC for a fleet user: ``batch`` cold-started scenarios
per call.

Each scenario has a gait drawn from the seed among the workload's
``gaits`` (the gait-table sweep), a contact-table phase of its own, and a
commanded speed, height and feet drawn as ``make_example_inputs`` draws
them. Set-up makes ``pool`` such batches; the calls cycle through them.
"""

from __future__ import annotations

import numpy as np

from mpcbench.traffic import Inputs, Traffic
from mpcbench.traffic._frozen.centroidal_inputs import gait_table, packed_inputs


def make(config: dict, params: dict, seed: int) -> Traffic:
    rng = np.random.default_rng(seed)
    B, N, gaits = params["batch"], config["horizon"], params["gaits"]
    tables = np.stack([[gait_table(g, N, ph) for ph in range(N)]
                       for g in gaits])  # (gaits, N phases, N, legs)
    pool = []
    for _ in range(params["pool"]):
        g = rng.integers(len(gaits), size=B)
        ph = rng.integers(N, size=B)
        pool.append(packed_inputs(config, params, rng, tables[g, ph]))

    def inputs(k: int, prev) -> Inputs:
        return Inputs(pool[k % len(pool)], None)

    return Traffic(batch=B, reads=("contact_force", "u_traj"),
                   warmup=params["warmup"], inputs=inputs)
