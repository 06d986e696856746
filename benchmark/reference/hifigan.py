"""The HiFi-GAN V1 generator (Kong, Kim and Bae, NeurIPS 2020, arXiv
2010.05646), written from the paper and the public code's ``Generator``
and ``ResBlock1`` (github.com/jik876/hifi-gan, ``models.py``), in float32
with every operand of a convolution through :class:`.lowp.Arith`, so that
the same code is the reference and its fp8 control. Widths are the
configuration's ``Vocoder.HiFiGAN`` (V1: rates 8, 8, 2, 2, kernels 16, 16,
4, 4, 512 channels, ResBlock1 kernels 3, 7, 11 with dilations 1, 3, 5).

    x = conv_pre(mel)                                   # k 7, pad 3
    for each stage i: x = MRF_i(ConvT_i(lrelu(x, 0.1)))  # stride u_i, pad (k_i - u_i) / 2
    MRF: the mean over the ResBlock1s of x; ResBlock1, for each dilation d:
         x = x + conv2(lrelu(conv1_d(lrelu(x, 0.1)), 0.1))
    wav = tanh(conv_post(lrelu(x, 0.01)))               # k 7, pad 3

Weights (:func:`draw_weights`) are drawn from a seed with numpy, weight
norm folded (its gain starts at the direction's norm, so the folded weight
is the drawn one): the ResBlocks' as the public code's ``init_weights``,
normal(0, 0.01); ``conv_pre``'s and every bias torch's default, uniform
within 1 / sqrt(fan_in) (torch's fan_in); the upsampling layers' and
``conv_post``'s Kaiming-normal for the LeakyReLU before each,
sqrt(2 / (1 + slope^2) / taps), taps the inputs that reach one output
(C_in k / u for a transposed convolution). The public code draws these last
normal(0, 0.01) too, which leaves a waveform of its biases alone: on 32
frames of the demo clips' mels the mel's share of it was about 3e-6 of
full scale. A trained generator carries the mel to the waveform, as these
weights do.

The stages apart (:func:`pre`, :func:`stage`, :func:`post`) let a check
follow the program stage by stage from its own activations.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.lowp import FULL, Arith

SLOPE, FINAL_SLOPE = 0.1, 0.01


def names(cfg: dict, n_mels: int) -> dict[str, tuple]:
    """{public module name: shape} of the generator, the folded weights."""
    C, rates = cfg["Upsample_Initial_Channel"], cfg["Upsample_Rates"]
    out = {"conv_pre.weight": (C, n_mels, 7), "conv_pre.bias": (C,)}
    for i, k in enumerate(cfg["Upsample_Kernel_Sizes"]):
        out[f"ups.{i}.weight"] = (C >> i, C >> (i + 1), k)
        out[f"ups.{i}.bias"] = (C >> (i + 1),)
    j = 0
    for i in range(len(rates)):
        c = C >> (i + 1)
        for k, dil in zip(cfg["Resblock_Kernel_Sizes"], cfg["Resblock_Dilation_Sizes"]):
            for conv in ("convs1", "convs2"):
                for m in range(len(dil)):
                    out[f"resblocks.{j}.{conv}.{m}.weight"] = (c, c, k)
                    out[f"resblocks.{j}.{conv}.{m}.bias"] = (c,)
            j += 1
    c = C >> len(rates)
    out["conv_post.weight"], out["conv_post.bias"] = (1, c, 7), (1,)
    return out


def draw_weights(cfg: dict, n_mels: int, rng: np.random.Generator) -> dict[str, np.ndarray]:
    """The generator's folded f32 weights by public module name."""
    shapes = names(cfg, n_mels)
    out = {}
    for name, shape in shapes.items():
        if name.endswith(".bias") or name == "conv_pre.weight":
            w = shapes[name[:-len("bias")] + "weight"] if name.endswith(".bias") else shape
            bound = 1.0 / np.sqrt(w[1] * w[2])  # torch's fan_in: dim 1 x kernel
            out[name] = rng.uniform(-bound, bound, shape)
        elif name.startswith("resblocks."):
            out[name] = rng.normal(0.0, 0.01, shape)
        elif name.startswith("ups."):
            u = cfg["Upsample_Rates"][int(name.split(".")[1])]
            std = np.sqrt(2.0 / (1 + SLOPE ** 2) / (shape[0] * shape[2] / u))
            out[name] = rng.normal(0.0, std, shape)
        else:  # conv_post
            std = np.sqrt(2.0 / (1 + FINAL_SLOPE ** 2) / (shape[1] * shape[2]))
            out[name] = rng.normal(0.0, std, shape)
    return {k: v.astype(np.float32) for k, v in out.items()}


def _conv(W, name, x, ar: Arith, **kw):
    return F.conv1d(ar.q(x), ar.q(W[name + ".weight"]), W[name + ".bias"], **kw)


def resblock1(W, j: int, x, k: int, dilations, ar: Arith = FULL):
    for m, d in enumerate(dilations):
        xt = _conv(W, f"resblocks.{j}.convs1.{m}", F.leaky_relu(x, SLOPE), ar, dilation=d,
                   padding=d * (k - 1) // 2)
        x = x + _conv(W, f"resblocks.{j}.convs2.{m}", F.leaky_relu(xt, SLOPE), ar,
                      padding=(k - 1) // 2)
    return x


def pre(W: dict, mel: torch.Tensor, ar: Arith = FULL) -> torch.Tensor:
    """(B, T, mels) -> conv_pre's (B, C, T)."""
    return _conv(W, "conv_pre", mel.transpose(1, 2), ar, padding=3)


def stage(W: dict, i: int, x: torch.Tensor, cfg: dict, ar: Arith = FULL) -> torch.Tensor:
    """Stage ``i``: LeakyReLU(0.1), the transposed convolution, the MRF."""
    u, k = cfg["Upsample_Rates"][i], cfg["Upsample_Kernel_Sizes"][i]
    ks, dils = cfg["Resblock_Kernel_Sizes"], cfg["Resblock_Dilation_Sizes"]
    x = F.conv_transpose1d(ar.q(F.leaky_relu(x, SLOPE)), ar.q(W[f"ups.{i}.weight"]),
                           W[f"ups.{i}.bias"], stride=u, padding=(k - u) // 2)
    return sum(resblock1(W, i * len(ks) + j, x, kk, d, ar)
               for j, (kk, d) in enumerate(zip(ks, dils))) / len(ks)


def post(W: dict, x: torch.Tensor, ar: Arith = FULL) -> torch.Tensor:
    """LeakyReLU(0.01), conv_post, tanh -> (B, L)."""
    return torch.tanh(_conv(W, "conv_post", F.leaky_relu(x, FINAL_SLOPE), ar, padding=3)[:, 0])


def generate(W: dict, mel: torch.Tensor, cfg: dict, ar: Arith = FULL) -> torch.Tensor:
    """(B, T, mels) -> (B, T x hop) waveform; ``W`` the weights as f32
    tensors on ``mel``'s device."""
    x = pre(W, mel, ar)
    for i in range(len(cfg["Upsample_Rates"])):
        x = stage(W, i, x, cfg, ar)
    return post(W, x, ar)
