"""Bound of the HiFi-GAN generator (``models/hifigan.py``: cuDNN's
convolutions, bf16 operands, f32 sums) on one batch, and the operations of
the whole synthesis step of a configuration that vocodes with it.

The generator's work at each row's decoded frames, 2 operations a
multiply-add: ``conv_pre`` 2 mels C 7 a frame; stage i's transposed
convolution 2 C_i C_i+1 k_i a sample of its input and its MRF, two
convolutions of C_i+1^2 k a dilation of each ResBlock1, a sample of its
output; ``conv_post`` 2 C 7 an output sample (V1: 614.1 MFLOP a frame, 594.5
of them the MRFs'). Each input mel (f32) read once, each output sample
(f32) written once, the bf16 weights read once a batch. bf16 peak.

The whole step (``step_flops``): ``rooflines/models.py``'s encoder, decoder
and postnet at each request's own lengths, then the generator; no linear
head and no Griffin-Lim.
"""

from __future__ import annotations

import math

from benchmark.harness.peaks import BF16_FLOPS, bound_s
from benchmark.rooflines import decode


def frame_flops(cfg: dict, n_mels: int) -> float:
    C, rates, kernels = (cfg["Upsample_Initial_Channel"], cfg["Upsample_Rates"],
                         cfg["Upsample_Kernel_Sizes"])
    flops = 2 * n_mels * C * 7
    for i, (u, k) in enumerate(zip(rates, kernels)):
        c_in, c_out, L_in = C >> i, C >> (i + 1), math.prod(rates[:i])
        flops += 2 * c_in * c_out * k * L_in
        flops += L_in * u * sum(2 * len(d) * 2 * c_out * c_out * kk for kk, d in
                                zip(cfg["Resblock_Kernel_Sizes"], cfg["Resblock_Dilation_Sizes"]))
    return flops + 2 * (C >> len(rates)) * 7 * math.prod(rates)


def parameters(cfg: dict, n_mels: int) -> int:
    C, rates = cfg["Upsample_Initial_Channel"], cfg["Upsample_Rates"]
    n = n_mels * C * 7 + C
    for i, k in enumerate(cfg["Upsample_Kernel_Sizes"]):
        c = C >> (i + 1)
        n += (C >> i) * c * k + c
        n += sum(2 * len(d) * (c * c * kk + c) for kk, d in
                 zip(cfg["Resblock_Kernel_Sizes"], cfg["Resblock_Dilation_Sizes"]))
    return n + (C >> len(rates)) * 7 + 1


def batch_bound_s(hp: dict, batch: dict) -> float:
    cfg, snd = hp["Vocoder"]["HiFiGAN"], hp["Sound"]
    frames = sum(batch["frames"])
    n_bytes = (4 * frames * snd["Mel_Dim"] + 4 * frames * snd["Frame_Shift"]
               + 2 * parameters(cfg, snd["Mel_Dim"]))
    return bound_s(n_bytes, frames * frame_flops(cfg, snd["Mel_Dim"]), BF16_FLOPS)


def step_flops(hp: dict, batch: dict, tokens: list[int]) -> float:
    enc, snd = hp["Encoder"], hp["Sound"]
    C, Kc, E = enc["Conv"]["Channels"], enc["Conv"]["Kernel_Size"], enc["Embedding_Size"]
    h = enc["LSTM_Size"] // 2
    per_token = (2 * Kc * E * C + (enc["Conv"]["Stacks"] - 1) * 2 * Kc * C * C
                 + 2 * 2 * 4 * h * (C + h))
    mel = snd["Mel_Dim"]
    post = hp["Postnet"]["Conv"]
    pc, pk = post["Channels"], post["Kernel_Size"]
    per_frame = (2 * pk * (mel * pc + (post["Stacks"] - 2) * pc * pc + pc * mel)
                 + frame_flops(hp["Vocoder"]["HiFiGAN"], mel))
    return (sum(tokens) * per_token
            + sum(batch["steps"]) * decode.row_step_flops(decode.widths(hp), batch["S"])
            + sum(batch["frames"]) * per_frame)
