"""Transport between the planning and tracking sides (numpy, ctypes)."""

from cheeta_mpc_tpu_torch.transport.bus import MessageBus  # noqa: F401
from cheeta_mpc_tpu_torch.transport.mpc_mrt import (  # noqa: F401
    MpcNode,
    MrtNode,
)
from cheeta_mpc_tpu_torch.transport.wire import (  # noqa: F401
    decode_observation,
    decode_policy,
    encode_observation,
    encode_policy,
)
