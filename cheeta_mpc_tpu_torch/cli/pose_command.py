"""Pose command utility (reference LeggedRobotPoseCommandNode.cpp:48-120):
convert a displacement command [dx, dy, dz, dyaw_deg] into a two-point
target trajectory with a velocity-based arrival time.

A copy of ``cheeta_mpc_tpu/cli/pose_command.py`` on the port's transport.
"""

from __future__ import annotations

import sys

import numpy as np

TARGET_DISPLACEMENT_VELOCITY = 0.5  # m/s (reference reference.info)
TARGET_ROTATION_VELOCITY = 1.57  # rad/s


def command_to_target(current_pose: np.ndarray, dx: float, dy: float,
                      dz: float, dyaw_deg: float,
                      v_lin: float = TARGET_DISPLACEMENT_VELOCITY,
                      v_rot: float = TARGET_ROTATION_VELOCITY):
    """Returns (times (2,), poses (2, 4)): [x, y, z, yaw] now and at arrival.

    Arrival time = max(linear displacement / v_lin, rotation / v_rot)
    (reference estimateTimeToTarget semantics).
    """
    dyaw = np.deg2rad(dyaw_deg)
    disp = np.linalg.norm([dx, dy, dz])
    t_arrival = max(disp / v_lin, abs(dyaw) / v_rot, 1e-3)
    target = np.asarray(current_pose, float) + np.asarray([dx, dy, dz, dyaw])
    return (np.array([0.0, t_arrival]),
            np.stack([np.asarray(current_pose, float), target]))


def run(stdin=None, stdout=None, bus=None):
    """Interactive loop. With ``bus`` set, each command is published LIVE to
    a running ``cli/launch.py`` topology on the ``mpc_target`` topic (the
    reference's `_mpc_target` path, TargetTrajectoriesRosPublisher.cpp:
    40-60): the displacement command becomes the constant-velocity command
    ``[dx, dy, dyaw] / t_arrival`` that reaches the pose at the reference's
    velocity-based arrival time — the form the planner's velocity-command
    reference generator consumes."""
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    pose = np.zeros(4)
    client = None
    shm = None
    if bus is not None:
        from cheeta_mpc_tpu_torch.transport.mpc_mrt import (TOPICS,
                                                            CommandClient)
        from cheeta_mpc_tpu_torch.transport.shm import ShmMessageBus
        shm = ShmMessageBus(TOPICS, bus)
        client = CommandClient(shm)
        print(f"attached to live bus {bus}", file=stdout)
    try:
        print("Enter: dx dy dz dyaw_deg (Ctrl-D to quit)", file=stdout)
        for line in stdin:
            try:
                dx, dy, dz, dyaw = (float(v) for v in line.split())
            except ValueError:
                print("expected 4 numbers", file=stdout)
                continue
            times, poses = command_to_target(pose, dx, dy, dz, dyaw)
            pose = poses[-1]
            if client is not None:
                t_arr = float(times[-1])
                v_cmd = np.array([dx / t_arr, dy / t_arr,
                                  np.deg2rad(dyaw) / t_arr])
                client.publish_target(v_cmd)
            print(f"target at t+{times[-1]:.2f}s: "
                  f"x={pose[0]:.2f} y={pose[1]:.2f} z={pose[2]:.2f} "
                  f"yaw={np.rad2deg(pose[3]):.1f}deg", file=stdout)
    finally:
        if shm is not None:
            shm.close()


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--bus", default=None,
                    help="shared-memory bus name of a running "
                         "cli/launch.py topology to publish into")
    args = ap.parse_args(argv)
    run(bus=args.bus)
    return 0


if __name__ == "__main__":
    sys.exit(main())
