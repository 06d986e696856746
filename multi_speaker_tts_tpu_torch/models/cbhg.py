"""CBHG: the Taco1-style mel -> linear post-processing network (port of
``multi_speaker_tts_tpu.models.cbhg``).

Conv1D bank (k = 1..K, relu) -> concat -> max-pool (window 2, stride 1) ->
two conv projections (k = 3; relu, then none) -> residual -> highway stack
-> bidirectional GRU. The convolutions run in the compute dtype
(:class:`..layers.ConvBNBlock`); the residual, ``pre_highway``, the
highways and :class:`CBHGHead`'s output projection are f32; the BiGRU gets
the compute dtype and, on a CUDA tensor, runs ``csrc/bigru.cu`` (and, under
autograd, ``csrc/bigru_bwd.cu`` in the backward). ``train`` switches the
BatchNorms to batch statistics; the CBHG's convolutions have no dropout,
as in the JAX module.

Padding follows XLA's SAME: (k-1)//2 left and k//2 right for the even bank
kernels, and the pool pads one frame of -inf on the right only, so
y[t] = max(x[t], x[t+1]) and the last frame stands alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multi_speaker_tts_tpu_torch.models.layers import BiGRU, ConvBNBlock, Dense, Highway


class CBHG(nn.Module):
    """(B, T, d_in) -> (B, T, gru_size)."""

    def __init__(self, d_in: int, bank_k: int = 8, bank_channels: int = 128,
                 projection_channels: int = 256, highway_layers: int = 4,
                 highway_size: int = 128, gru_size: int = 256):
        super().__init__()
        self.bank = nn.ModuleList(
            ConvBNBlock(d_in, bank_channels, k, "relu") for k in range(1, bank_k + 1)
        )
        self.proj_0 = ConvBNBlock(bank_k * bank_channels, projection_channels, 3, "relu")
        self.proj_1 = ConvBNBlock(projection_channels, d_in, 3, "none")
        self.pre_highway = Dense(d_in, highway_size) if d_in != highway_size else None
        self.highways = nn.ModuleList(Highway(highway_size) for _ in range(highway_layers))
        self.gru = BiGRU(highway_size, gru_size)

    def forward(self, x: torch.Tensor, compute_dtype, train: bool = False) -> torch.Tensor:
        y = torch.cat([conv(x, compute_dtype, train) for conv in self.bank], dim=-1)
        y = F.max_pool1d(F.pad(y.transpose(1, 2), (0, 1), value=float("-inf")),
                         kernel_size=2, stride=1).transpose(1, 2)
        y = self.proj_1(self.proj_0(y, compute_dtype, train), compute_dtype, train)
        y = y.float() + x
        if self.pre_highway is not None:
            y = self.pre_highway(y)
        for highway in self.highways:
            y = highway(y)
        return self.gru(y, compute_dtype)


class CBHGHead(nn.Module):
    """Mel -> linear spectrogram: CBHG + an f32 output projection."""

    def __init__(self, mel_dim: int, spect_dim: int, gru_size: int = 256, **cbhg):
        super().__init__()
        self.cbhg = CBHG(mel_dim, gru_size=gru_size, **cbhg)
        self.projection = Dense(2 * (gru_size // 2), spect_dim)

    def forward(self, mel: torch.Tensor, compute_dtype, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` is taken as the other heads take it, and unused:
        no dropout here."""
        return self.projection(self.cbhg(mel, compute_dtype, train))
