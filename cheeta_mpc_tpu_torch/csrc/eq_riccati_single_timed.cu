// K3's instantiation with section timers, launched by
// cheeta_eq_riccati_single (eq_riccati_single.cu) when it is given a timer
// buffer.
#include "eq_launch.inl"

int cheeta::launch_eq_single_timed(CHEETA_EQ_LAUNCH_PARAMS) {
  return cheeta::launch_eq(cheeta::eq_riccati_single_kernel<true>,
                           CHEETA_EQ_LAUNCH_ARGS);
}
