"""Frozen copies of the port's host-side gait helpers that the legged traffic
uses: the motion-phase flags, the gait schedule with its trot template, and
the swing-height planner at its default ``SwingConfig``. Copied so that a
change to the program cannot change the traffic it is measured on."""
