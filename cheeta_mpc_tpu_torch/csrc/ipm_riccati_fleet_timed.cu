// K2's instantiation with section timers, launched by
// cheeta_ipm_riccati_fleet (ipm_riccati_fleet.cu) when it is given a timer
// buffer.
#include "ipm_launch.inl"

int cheeta::launch_fleet_timed(CHEETA_IPM_LAUNCH_PARAMS) {
  return cheeta::launch(
      CHEETA_PICK_FLEET(scratch == nullptr, dims[4] > 0, true),
      CHEETA_IPM_LAUNCH_ARGS);
}
