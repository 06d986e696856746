"""The HiFi-GAN V1 generator (Kong, Kim and Bae, NeurIPS 2020, arXiv
2010.05646): mel frames -> waveform, ``hop`` samples a frame; the vocoder of
``Vocoder.Type: HiFiGAN`` (``inference.Synthesizer``).

``conv_pre`` (mels -> C, k 7, pad 3), then for each stage i:
LeakyReLU(0.1) -> ConvTranspose1d(C_i -> C_i / 2, k_i, stride u_i, padding
(k_i - u_i) / 2) -> MRF, the mean over ResBlock1s of kernel sizes
``Resblock_Kernel_Sizes`` on the same input, each one for every dilation d
``x = x + conv2(lrelu(conv1_d(lrelu(x, 0.1)), 0.1))`` (conv1_d: dilation d,
pad d (k - 1) / 2; conv2: dilation 1); then LeakyReLU at 0.01 (the public
code's ``F.leaky_relu(x)`` default), ``conv_post`` (C -> 1, k 7, pad 3) and
tanh. V1's widths are :data:`V1`.

Weights: the public generator's module names (``conv_pre.weight``,
``ups.{i}.weight``, ``resblocks.{j}.convs1.{k}.weight``, ...,
``conv_post.bias``) with weight norm folded into each weight, as f32
arrays (:meth:`HiFiGAN.load`, :func:`read_weights`). Arithmetic: every
convolution's operands in the compute dtype (bf16 under
``Use_Mixed_Precision``) with f32 sums, the activations fed to them
rounded from f32, the residual stream and the MRF's mean in f32.

Two routes (:func:`..ops.hifigan_mrf.use_kernel`). bf16 on the card: the
MRFs run as the channels-last kernels of :mod:`..ops.hifigan_mrf` (bias,
LeakyReLU, rounding, residual and mean in their epilogues), the transposed
convolutions and ``conv_post`` as cuDNN's on (B, C, 1, L) channels-last
views of the kernels' (B, L, C) buffers, without a layout pass, each fed
by one activation pass; stage outputs are (B, C, L) views of those
buffers. A width the kernels were not built for raises there. A CPU tensor
or an f32 compute dtype runs the plain path (:func:`plain_mrf`), cuDNN's
(B, C, L) convolutions whose bf16 outputs are rounded before the bias and
activation.

The forward is :meth:`HiFiGAN.pre`, :meth:`HiFiGAN.stage` for each stage
and :meth:`HiFiGAN.post`. Spans (:mod:`..telemetry`): ``vocode.up{i}``
around stage i; the count ``vocode.row_frames``, rows x frames, once a
call; ``vocode.mrf_kernel_steps``, rows x dilation steps the kernels ran,
once a step.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multi_speaker_tts_tpu_torch import telemetry
from multi_speaker_tts_tpu_torch.hparams import vocoder_type
from multi_speaker_tts_tpu_torch.ops import _build, hifigan_mrf

V1 = {  # config_v1.json of github.com/jik876/hifi-gan
    "Upsample_Rates": [8, 8, 2, 2],
    "Upsample_Kernel_Sizes": [16, 16, 4, 4],
    "Upsample_Initial_Channel": 512,
    "Resblock_Kernel_Sizes": [3, 7, 11],
    "Resblock_Dilation_Sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}
SLOPE = 0.1  # LRELU_SLOPE of the public code


def _conv(c_in: int, c_out: int, k: int, transposed: bool = False) -> nn.Module:
    """A convolution's folded weight (torch's layout: (out, in, k), or
    (in, out, k) transposed) and bias."""
    m = nn.Module()
    m.weight = nn.Parameter(torch.empty((c_in, c_out, k) if transposed else (c_out, c_in, k)))
    m.bias = nn.Parameter(torch.empty(c_out))
    return m


def _apply(conv: nn.Module, x: torch.Tensor, dtype, **kw) -> torch.Tensor:
    """``conv`` on f32 ``x`` rounded to ``dtype`` -> f32."""
    return F.conv1d(x.to(dtype), conv.weight, conv.bias, **kw).float()


def _activation(x: torch.Tensor, slope: float, dtype) -> torch.Tensor:
    """``lrelu(x, slope)`` of an f32 (B, C, L) ``x`` in ``dtype`` as a
    (B, L, C)-contiguous tensor (one copy first where ``x`` is not a view of
    one)."""
    return hifigan_mrf.activation(_channels_last(x), slope, dtype)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    """(B, C, L) -> a (B, L, C)-contiguous tensor: a view where ``x`` is one."""
    xl = x.transpose(1, 2)
    return xl if xl.is_contiguous() else xl.contiguous()


def _w4(w: torch.Tensor) -> torch.Tensor:
    return w.unsqueeze(2).contiguous(memory_format=torch.channels_last)


def _conv_cl(a: torch.Tensor, weight, bias=None, transposed: bool = False, stride: int = 1,
             padding: int = 0) -> torch.Tensor:
    """A 1-D convolution of the (B, L, C) ``a`` -> (B, L', C') in a's dtype,
    through the 2-D one on the (B, C, 1, L) channels-last view (``conv1d``
    would copy a channels-last input to (B, C, L) first)."""
    a4 = a.unsqueeze(1).permute(0, 3, 1, 2)
    w4 = _build.packed(_w4, weight)
    if transposed:
        y = F.conv_transpose2d(a4, w4, bias, stride=(1, stride), padding=(0, padding))
    else:
        y = F.conv2d(a4, w4, bias, padding=(0, padding))
    return y[:, :, 0].transpose(1, 2).contiguous()


def plain_mrf(blocks, x: torch.Tensor, dtype) -> torch.Tensor:
    """The MRF's plain path: the mean of ``blocks`` on the f32 (B, C, L)
    ``x``, each convolution's operands in ``dtype``."""
    xs = blocks[0](x, dtype)
    for block in blocks[1:]:
        xs = xs + block(x, dtype)
    return xs / len(blocks)


class ResBlock1(nn.Module):
    """(B, C, L) f32 -> (B, C, L) f32: for each dilation d,
    ``x = x + conv2(lrelu(conv1_d(lrelu(x))))``."""

    def __init__(self, channels: int, kernel_size: int, dilations):
        super().__init__()
        self.kernel_size, self.dilations = kernel_size, tuple(dilations)
        self.convs1 = nn.ModuleList(_conv(channels, channels, kernel_size) for _ in dilations)
        self.convs2 = nn.ModuleList(_conv(channels, channels, kernel_size) for _ in dilations)

    def shapes(self) -> tuple[tuple[int, int, int], ...]:
        """(C, k, d) of its convolutions: conv 1 at each dilation, conv 2 at 1."""
        C = self.convs1[0].weight.shape[0]
        return tuple((C, self.kernel_size, d) for d in (*self.dilations, 1))

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        k = self.kernel_size
        for c1, c2, d in zip(self.convs1, self.convs2, self.dilations):
            xt = _apply(c1, F.leaky_relu(x, SLOPE), dtype, dilation=d, padding=d * (k - 1) // 2)
            x = x + _apply(c2, F.leaky_relu(xt, SLOPE), dtype, padding=(k - 1) // 2)
        return x


class HiFiGAN(nn.Module):
    """(B, T, mels) f32 mel frames -> (B, T * hop) f32 waveform in [-1, 1]."""

    final_slope = 0.01  # the public code's ``F.leaky_relu(x)`` before conv_post

    def __init__(self, n_mels: int, rates, kernel_sizes, initial_channel: int,
                 resblock_kernel_sizes, resblock_dilations, compute_dtype=torch.float32):
        super().__init__()
        if len(rates) != len(kernel_sizes):
            raise ValueError(f"{len(rates)} upsample rates but {len(kernel_sizes)} kernel sizes")
        if any((k - u) % 2 for u, k in zip(rates, kernel_sizes)):
            raise ValueError(f"kernel minus rate must be even: rates {rates}, "
                             f"kernels {kernel_sizes}")
        if initial_channel % (1 << len(rates)):
            raise ValueError(f"{initial_channel} channels do not halve {len(rates)} times")
        self.rates, self.kernel_sizes = tuple(rates), tuple(kernel_sizes)
        self.n_kernels = len(resblock_kernel_sizes)
        self.compute_dtype = compute_dtype
        self.conv_pre = _conv(n_mels, initial_channel, 7)
        self.ups = nn.ModuleList(
            _conv(initial_channel >> i, initial_channel >> (i + 1), k, transposed=True)
            for i, k in enumerate(kernel_sizes))
        self.resblocks = nn.ModuleList(
            ResBlock1(initial_channel >> (i + 1), k, d)
            for i in range(len(rates))
            for k, d in zip(resblock_kernel_sizes, resblock_dilations))
        self.conv_post = _conv(initial_channel >> len(rates), 1, 7)
        self._shapes = tuple(sorted({s for b in self.resblocks for s in b.shapes()}))

    @classmethod
    def from_hp(cls, hp, compute_dtype=torch.float32) -> "HiFiGAN":
        """``hp.Vocoder.HiFiGAN``'s widths at ``hp.Sound``'s mels; the
        product of the rates has to be ``Sound.Frame_Shift``."""
        cfg = hp.Vocoder.HiFiGAN
        rates = list(cfg.Upsample_Rates)
        if math.prod(rates) != hp.Sound.Frame_Shift:
            raise ValueError(f"the upsample rates {rates} multiply to {math.prod(rates)}, "
                             f"not Sound.Frame_Shift {hp.Sound.Frame_Shift}")
        return cls(hp.Sound.Mel_Dim, rates, list(cfg.Upsample_Kernel_Sizes),
                   cfg.Upsample_Initial_Channel, list(cfg.Resblock_Kernel_Sizes),
                   [list(d) for d in cfg.Resblock_Dilation_Sizes], compute_dtype)

    def load(self, weights: dict) -> "HiFiGAN":
        """The public generator's folded f32 arrays by module name, every
        one present and of its shape, nothing left over; the convolutions'
        weights and biases kept in the compute dtype."""
        expected = self.state_dict()
        missing, extra = sorted(set(expected) - set(weights)), sorted(set(weights) - set(expected))
        if missing or extra:
            raise ValueError(f"HiFi-GAN weights: missing {missing[:5]}, unexpected {extra[:5]}")
        for key, value in weights.items():
            if tuple(np.shape(value)) != tuple(expected[key].shape):
                raise ValueError(f"HiFi-GAN {key}: shape {np.shape(value)} != "
                                 f"{tuple(expected[key].shape)}")
        self.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                              for k, v in weights.items()})
        return self.to(self.compute_dtype)

    def _kernels(self, x: torch.Tensor) -> bool:
        """Whether the stages run the MRF kernels on ``x``."""
        return hifigan_mrf.use_kernel(x, self.compute_dtype, self._shapes)

    def mrf(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Stage ``i``'s multi-receptive-field fusion: the mean of its
        ResBlock1s on ``x``."""
        blocks = self.resblocks[i * self.n_kernels:(i + 1) * self.n_kernels]
        if self._kernels(x):
            return hifigan_mrf.mrf(blocks, _channels_last(x)).transpose(1, 2)
        return plain_mrf(blocks, x, self.compute_dtype)

    def pre(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, mels) -> conv_pre's (B, C, T), f32."""
        return _apply(self.conv_pre, mel.transpose(1, 2), self.compute_dtype, padding=3)

    def stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Stage ``i``: LeakyReLU(0.1), the transposed convolution, the MRF."""
        u, k = self.rates[i], self.kernel_sizes[i]
        with telemetry.span(f"vocode.up{i}"):
            if self._kernels(x):
                y = _conv_cl(_activation(x, SLOPE, self.compute_dtype), self.ups[i].weight,
                             transposed=True, stride=u, padding=(k - u) // 2)
                x = hifigan_mrf.mrf_in(y, self.ups[i].bias).transpose(1, 2)
            else:
                x = F.conv_transpose1d(F.leaky_relu(x, SLOPE).to(self.compute_dtype),
                                       self.ups[i].weight, self.ups[i].bias, stride=u,
                                       padding=(k - u) // 2).float()
            return self.mrf(i, x)

    def post(self, x: torch.Tensor) -> torch.Tensor:
        """LeakyReLU(``final_slope``), conv_post, tanh -> (B, L)."""
        if self._kernels(x):
            y = _conv_cl(_activation(x, self.final_slope, self.compute_dtype),
                         self.conv_post.weight, self.conv_post.bias, padding=3)
            return torch.tanh(y[..., 0].float())
        x = _apply(self.conv_post, F.leaky_relu(x, self.final_slope), self.compute_dtype,
                   padding=3)
        return torch.tanh(x[:, 0])

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        telemetry.count("vocode.row_frames", mel.shape[0] * mel.shape[1])
        x = self.pre(mel)
        for i in range(len(self.ups)):
            x = self.stage(i, x)
        return self.post(x)


def read_weights(hp) -> dict | None:
    """The generator's weights from the ``.npz`` that
    ``Vocoder.HiFiGAN.Weights`` names, where ``hp`` asks for the generator;
    None for Griffin-Lim (or no hp)."""
    if hp is None or vocoder_type(hp) != "HiFiGAN":
        return None
    path = hp.Vocoder.HiFiGAN.get("Weights")
    if not path:
        raise ValueError("Vocoder.Type HiFiGAN: name the generator's weights (.npz) "
                         "in Vocoder.HiFiGAN.Weights")
    with np.load(path, allow_pickle=False) as npz:
        return {k: npz[k] for k in npz.files}

