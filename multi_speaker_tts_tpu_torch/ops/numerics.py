"""Mixed-precision arithmetic shared by the plain versions.

The JAX package computes in ``compute_dtype`` (bf16 for mixed-precision
checkpoints) with f32 accumulation. The port's plain versions reproduce
that on any device the same way: round each operand to the compute dtype,
then do the arithmetic in f32. A product of two bf16 values is exact in
f32, so this is the numerics of a bf16 tensor-core product with f32
accumulation, up to the order of the sum.
"""

from __future__ import annotations

import torch


def rounded(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``compute_dtype`` and held as f32."""
    if compute_dtype == torch.float32:
        return x.float()
    return x.to(compute_dtype).float()


def seq_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over (t, b) of a^T b for (T, B, M) x (T, B, N) -> (M, N) f32: a
    deferred whole-sequence weight gradient, compute-dtype operands summed
    in f32 (the JAX package's ``dot_general(..., preferred_element_type=f32)``)."""
    return a.reshape(-1, a.shape[-1]).float().t() @ b.reshape(-1, b.shape[-1]).float()


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd will want gradients through these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def compute_dtype_of(hp) -> torch.dtype:
    return torch.bfloat16 if hp.Train.Use_Mixed_Precision else torch.float32
