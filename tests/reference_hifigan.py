"""A plain float32 HiFi-GAN generator for the port's tests, written from the
public code's ``Generator`` and ``ResBlock1`` (github.com/jik876/hifi-gan,
``models.py``; arXiv 2010.05646) in plain torch, apart from either package:

    x = conv_pre(mel)                                    # k 7, pad 3
    for each stage i: x = ConvT_i(lrelu(x, 0.1))         # stride u_i, pad (k_i - u_i) / 2
                      x = mean_j ResBlock1_j(x)          # the MRF
    ResBlock1, for each dilation d: x = x + conv2(lrelu(conv1_d(lrelu(x, 0.1)), 0.1))
    wav = tanh(conv_post(lrelu(x, 0.01)))                # k 7, pad 3

``seeded_weights`` draws folded weights by the public module names from a
torch generator, each normal with a variance that carries the signal
through (1 / fan_in), biases uniform within 1 / sqrt(fan_in).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def shapes(cfg: dict, n_mels: int) -> dict[str, tuple]:
    C, rates = cfg["Upsample_Initial_Channel"], cfg["Upsample_Rates"]
    out = {"conv_pre.weight": (C, n_mels, 7), "conv_pre.bias": (C,)}
    j = 0
    for i, k in enumerate(cfg["Upsample_Kernel_Sizes"]):
        c = C >> (i + 1)
        out[f"ups.{i}.weight"], out[f"ups.{i}.bias"] = (C >> i, c, k), (c,)
        for kk, dil in zip(cfg["Resblock_Kernel_Sizes"], cfg["Resblock_Dilation_Sizes"]):
            for conv in ("convs1", "convs2"):
                for m in range(len(dil)):
                    out[f"resblocks.{j}.{conv}.{m}.weight"] = (c, c, kk)
                    out[f"resblocks.{j}.{conv}.{m}.bias"] = (c,)
            j += 1
    c = C >> len(rates)
    out["conv_post.weight"], out["conv_post.bias"] = (1, c, 7), (1,)
    return out


def seeded_weights(cfg: dict, n_mels: int, seed: int) -> dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in shapes(cfg, n_mels).items():
        if name.endswith(".bias"):
            out[name] = (torch.rand(shape, generator=g) * 2 - 1) / 16.0
        else:
            fan_in = shape[0] * shape[2] if name.startswith("ups.") else shape[1] * shape[2]
            out[name] = torch.randn(shape, generator=g) / fan_in ** 0.5
    return out


def _conv(W, name, x, **kw):
    return F.conv1d(x, W[name + ".weight"], W[name + ".bias"], **kw)


def generate(W: dict, mel: torch.Tensor, cfg: dict, final_slope: float = 0.01,
             branches: int | None = None) -> torch.Tensor:
    """(B, T, mels) -> (B, T x hop). ``final_slope`` and ``branches`` (the
    MRF's first ``branches`` ResBlock1s only) let a test build the wrong
    generator the comparison has to tell apart."""
    ks, dils = cfg["Resblock_Kernel_Sizes"], cfg["Resblock_Dilation_Sizes"]
    n = len(ks) if branches is None else branches
    x = _conv(W, "conv_pre", mel.transpose(1, 2), padding=3)
    for i, (u, k) in enumerate(zip(cfg["Upsample_Rates"], cfg["Upsample_Kernel_Sizes"])):
        x = F.conv_transpose1d(F.leaky_relu(x, 0.1), W[f"ups.{i}.weight"], W[f"ups.{i}.bias"],
                               stride=u, padding=(k - u) // 2)
        outs = []
        for j, (kk, dil) in enumerate(zip(ks[:n], dils[:n])):
            y = x
            for m, d in enumerate(dil):
                name = f"resblocks.{i * len(ks) + j}"
                yt = _conv(W, f"{name}.convs1.{m}", F.leaky_relu(y, 0.1), dilation=d,
                           padding=d * (kk - 1) // 2)
                y = y + _conv(W, f"{name}.convs2.{m}", F.leaky_relu(yt, 0.1),
                              padding=(kk - 1) // 2)
            outs.append(y)
        x = sum(outs) / n
    x = _conv(W, "conv_post", F.leaky_relu(x, final_slope), padding=3)
    return torch.tanh(x[:, 0])
