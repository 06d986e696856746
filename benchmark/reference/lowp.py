"""The reference's arithmetic, at full precision or as its control.

``Arith(fp8=False)``: float32 products with TF32 off (see
:func:`no_tf32`). ``Arith(fp8=True)``: the control, the reference put in
the program's place one precision below the configuration's bf16: every
operand of a product (weights and activations, per tensor scaled to the
range of ``float8_e4m3fn``) rounded to fp8, the products summed in
float32. The rounding passes gradients straight through, so a training
control differentiates as the reference does.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Arith:
    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        low = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return x + (low - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def conv1d(self, x: torch.Tensor, w: torch.Tensor, bias=None, left: int = 0,
               right: int = 0) -> torch.Tensor:
        """(B, T, Cin) x flax kernel (K, Cin, Cout) -> (B, T', Cout), padded
        ``left`` / ``right`` frames with zeros."""
        xt = torch.nn.functional.pad(self.q(x).transpose(1, 2), (left, right))
        y = torch.nn.functional.conv1d(xt, self.q(w).permute(2, 1, 0))
        y = y.transpose(1, 2)
        return y if bias is None else y + bias


FULL = Arith(False)
