"""The arithmetic the reference runs in.

``F64`` is the reference: every operation in float64.  ``TF32`` is the
control of the correctness check (the nearest precision below the float32
that the configurations state): float32 with every matrix product's
operands rounded to TF32's 10-bit mantissa, as the tensor cores round them
when ``allow_tf32`` is on, and float32 accumulation.  The rounding is done
here on the bits, so the control runs alike on the CPU and on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to 10 mantissa bits, to nearest, ties away
    from zero; inf and NaN pass through."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    out = rounded.view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


@dataclass(frozen=True)
class Precision:
    name: str
    dtype: torch.dtype

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The matrix product ``a @ b`` in this precision."""
        if self.name == "tf32":
            return round_tf32(a) @ round_tf32(b)
        return a @ b

    def mv(self, A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.mm(A, v[..., None])[..., 0]


F64 = Precision("f64", torch.float64)
TF32 = Precision("tf32", torch.float32)
