"""Matrix products at TF32, emulated: the control's lower precision.

On the card a float32 product at TF32 rounds both operands to TF32 (a
10-bit mantissa, round to nearest even) and accumulates in float32. Turning
TF32 on (``allow_tf32``) does not make cuBLAS take that path for the
reference's small batched products, so the rounding is done here: inside
:class:`Tf32Products`, every ``matmul`` / ``@`` / ``bmm`` / ``mm`` of
float32 tensors rounds its operands first. Elementwise arithmetic, which
TF32 does not touch, is left as it is.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

_PRODUCTS = {torch.matmul, torch.bmm, torch.mm, torch.Tensor.matmul,
             torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
             torch.Tensor.bmm, torch.Tensor.mm}


def round_to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to the nearest TF32 value, ties to even."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class Tf32Products(TorchFunctionMode):
    """Every float32 matrix product inside the block at TF32."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _PRODUCTS:
            args = tuple(round_to_tf32(a) if isinstance(a, torch.Tensor)
                         and a.dtype == torch.float32 else a for a in args)
        return func(*args, **(kwargs or {}))
