from cheeta_mpc_tpu_torch.utils.timing import RepeatedTimer, Benchmarker  # noqa: F401
