"""Building blocks shared by the GE2E encoder and the synthesizer.

Port of ``multi_speaker_tts_tpu.models.layers``. Weights keep the JAX
layouts (Dense kernels (in, out), LSTM (D, 4H) / (H, 4H), location-conv
(K, 2, C)) except the Conv_0 kernels of :class:`ConvBNBlock`, which are
stored in torch's (out, in, K) order for ``conv1d``; ``weights.py`` maps a
checkpoint onto these names. Parameters are trainable; the serving entry
points run under ``torch.no_grad()``, so they build no autograd graph.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multi_speaker_tts_tpu_torch.ops.birnn_kernel import bigru, bilstm
from multi_speaker_tts_tpu_torch.ops.gru import GRUParams
from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams
from multi_speaker_tts_tpu_torch.ops.numerics import rounded
from multi_speaker_tts_tpu_torch.parallel import multihost

_BN_EPS = 1e-5  # flax BatchNorm default
_BN_MOMENTUM = 0.9  # the JAX package's ConvBNBlock


def weight(*shape: int) -> nn.Parameter:
    """A trainable weight; its values come from a checkpoint."""
    return nn.Parameter(torch.empty(*shape))


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            compute_dtype=torch.float32) -> torch.Tensor:
    """flax ``nn.Dropout`` in train mode: keep with probability 1 - rate,
    kept units scaled by 1 / keep_prob (in the compute dtype); rate 0 is the
    identity. The keep mask is drawn from ``generator``, at the global
    batch's shape in a data-parallel run (:func:`..parallel.multihost.global_rand`)."""
    if rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = multihost.global_rand(x.shape, generator, x.device) < keep_prob
    return rounded(torch.where(keep, x / keep_prob, torch.zeros_like(x)), compute_dtype)


class Dense(nn.Module):
    """y = x @ kernel (+ bias), kernel (in, out), in f32."""

    def __init__(self, d_in: int, d_out: int, use_bias: bool = True):
        super().__init__()
        self.kernel = weight(d_in, d_out)
        self.bias = weight(d_out) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class LSTMWeights(nn.Module):
    """One LSTM layer's weights: w_ih (D, 4H), w_hh (H, 4H), b (4H,)."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.w_ih = weight(d_in, 4 * hidden)
        self.w_hh = weight(hidden, 4 * hidden)
        self.b = weight(4 * hidden)

    @property
    def params(self) -> LSTMParams:
        return LSTMParams(self.w_ih, self.w_hh, self.b)


class BiLSTM(nn.Module):
    """(B, T, D) -> (B, T, 2 * (hidden_size // 2)), f32 output."""

    def __init__(self, d_in: int, hidden_size: int):
        super().__init__()
        self.forward_dir = LSTMWeights(d_in, hidden_size // 2)
        self.backward_dir = LSTMWeights(d_in, hidden_size // 2)

    def forward(self, x: torch.Tensor, compute_dtype) -> torch.Tensor:
        return bilstm(self.forward_dir.params, self.backward_dir.params, x,
                      compute_dtype)


class GRUWeights(nn.Module):
    """One GRU layer's weights: w_ih (D, 3H), w_hh (H, 3H), b_ih, b_hh (3H,)."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.w_ih = weight(d_in, 3 * hidden)
        self.w_hh = weight(hidden, 3 * hidden)
        self.b_ih = weight(3 * hidden)
        self.b_hh = weight(3 * hidden)

    @property
    def params(self) -> GRUParams:
        return GRUParams(self.w_ih, self.w_hh, self.b_ih, self.b_hh)


class BiGRU(nn.Module):
    """(B, T, D) -> (B, T, 2 * (hidden_size // 2)), f32 output."""

    def __init__(self, d_in: int, hidden_size: int):
        super().__init__()
        self.forward_dir = GRUWeights(d_in, hidden_size // 2)
        self.backward_dir = GRUWeights(d_in, hidden_size // 2)

    def forward(self, x: torch.Tensor, compute_dtype) -> torch.Tensor:
        return bigru(self.forward_dir.params, self.backward_dir.params, x,
                     compute_dtype)


class Highway(nn.Module):
    """out = relu(H(x)) * sigmoid(T(x)) + x * (1 - sigmoid(T(x))), in f32."""

    def __init__(self, size: int):
        super().__init__()
        self.H = Dense(size, size)
        self.T = Dense(size, size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = torch.sigmoid(self.T(x))
        return torch.relu(self.H(x)) * t + x * (1.0 - t)


class ConvBNBlock(nn.Module):
    """SAME Conv1d + BatchNorm + activation + dropout, in the compute dtype.

    Mirrors flax's mixed precision: input, kernel and bias rounded to the
    compute dtype, the conv output and the bias sum rounded back, the
    BatchNorm in f32 on that (statistics f32) and rounded again, the
    activation rounded. Returns f32 tensors holding compute-dtype values.

    ``train=False``: the running statistics, no dropout. ``train=True``
    (flax ``BatchNorm(use_running_average=False, momentum=0.9)``): the
    batch's mean and biased variance over (B, T) in f32 (E[y^2] - E[y]^2,
    clipped at 0), differentiated through; the running mean and variance
    move in place to 0.9 * running + 0.1 * batch; then dropout at
    ``dropout_rate`` with masks from the caller's generator. In a
    data-parallel run the batch is the global one: the sums of y and y^2
    and the row count are added over the processes (an autograd all-reduce)
    before the division, so every process moves its running statistics
    alike."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int,
                 activation: str = "relu", dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = float(dropout_rate)
        self.weight = weight(c_out, c_in, kernel_size)  # torch conv1d layout
        self.bias = weight(c_out)
        self.bn_scale = weight(c_out)
        self.bn_bias = weight(c_out)
        self.register_buffer("bn_mean", torch.empty(c_out))
        self.register_buffer("bn_var", torch.empty(c_out))
        if activation not in ("relu", "tanh", "none"):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation

    def forward(self, x: torch.Tensor, compute_dtype, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        K = self.weight.shape[-1]
        lo = (K - 1) // 2  # XLA SAME padding: (K-1)//2 left, K//2 right
        xk = F.pad(rounded(x, compute_dtype).transpose(1, 2), (lo, K - 1 - lo))
        y = F.conv1d(xk, rounded(self.weight, compute_dtype)).transpose(1, 2)
        y = rounded(rounded(y, compute_dtype) + rounded(self.bias, compute_dtype),
                    compute_dtype)
        if train:
            C = y.shape[-1]
            sums = multihost.all_reduce_autograd(torch.cat([
                y.sum(dim=(0, 1)), (y * y).sum(dim=(0, 1)),
                y.new_full((1,), float(y.shape[0] * y.shape[1]))]))
            mean = sums[:C] / sums[-1]
            var = torch.clamp(sums[C:2 * C] / sums[-1] - mean * mean, min=0.0)
            with torch.no_grad():
                self.bn_mean.copy_(_BN_MOMENTUM * self.bn_mean + (1.0 - _BN_MOMENTUM) * mean)
                self.bn_var.copy_(_BN_MOMENTUM * self.bn_var + (1.0 - _BN_MOMENTUM) * var)
        else:
            mean, var = self.bn_mean, self.bn_var
        mul = torch.rsqrt(var + _BN_EPS) * self.bn_scale
        y = rounded((y - mean) * mul + self.bn_bias, compute_dtype)
        if self.activation == "relu":
            y = torch.relu(y)
        elif self.activation == "tanh":
            y = rounded(torch.tanh(y), compute_dtype)
        if train:
            y = dropout(y, self.dropout_rate, generator, compute_dtype)
        return y


def prenet_apply(ws, x: torch.Tensor, dropout_rate: float, keep_masks=None):
    """Dense -> ReLU -> always-on dropout per layer. ``keep_masks`` holds one
    bool mask per layer, shaped as that layer's output ((B, size) a decode
    step, (B, n_steps, size) the teacher-forced sequence), drawn by the
    caller so tests can inject the JAX package's own draws; kept units are
    scaled by 1/keep_prob."""
    keep_prob = 1.0 - dropout_rate
    if dropout_rate > 0.0 and keep_masks is None:
        raise ValueError("prenet dropout is on: pass keep masks")
    for i, (kernel, bias) in enumerate(ws):
        x = torch.relu(x @ kernel + bias)
        if dropout_rate > 0.0:
            x = torch.where(keep_masks[i], x / keep_prob, torch.zeros_like(x))
    return x


def prenet_step(ws, dropout_rate: float, prenet_masks):
    """The AR decode's prenet ``(frame, t, rows=None) -> prenet(frame)``
    under step t's keep masks from ``prenet_masks(t)``, of the batch rows
    ``rows`` alone where given."""
    def prenet_fn(frame: torch.Tensor, t: int, rows: torch.Tensor | None = None):
        masks = None
        if dropout_rate > 0.0:
            masks = prenet_masks(t)
            masks = masks if rows is None else [m[rows] for m in masks]
        return prenet_apply(ws, frame, dropout_rate, masks)

    return prenet_fn
