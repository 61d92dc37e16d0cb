from cheeta_mpc_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_batch,
    sharded_batch_solver,
)
