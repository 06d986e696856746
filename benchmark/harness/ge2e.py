"""What the GE2E cells share: the configuration as the program's hp, the
seeded weights made on the device, and seeded batches of voices.

The weights are the benchmark's, not the program's: one uniform draw on the
device from the seed, sliced into the layers in the checkpoint tree's
layout (LSTM w_ih (D, 4H), w_hh (H, 4H), b (4H); projection kernel (H, E),
bias (E)), each scaled by 1 / sqrt(H) as PyTorch initializes an LSTM. The
same tensors go to the program's module and to the reference.
"""

from __future__ import annotations

import math

import torch

from benchmark.harness.cell import merge
from benchmark.reference import dsp as rdsp
from benchmark.traffic import voices


def hparams(ctx):
    """The program's hp: its defaults under the configuration's ``hp``."""
    from multi_speaker_tts_tpu_torch.hparams import default_hparams

    over = merge(ctx.cell.config["hp"], ctx.overrides.get("hp", {}))
    return default_hparams().replace(**over), over


def dims(hp) -> dict:
    g = hp.Speaker_Embedding
    return {"mel": hp.Sound.Mel_Dim, "H": g.GE2E.LSTM.Sizes, "layers": g.GE2E.LSTM.Stacks,
            "E": g.Embedding_Size}


def weights(seed: int, d: dict, device) -> dict:
    H, E = d["H"], d["E"]
    shapes = []
    for i in range(d["layers"]):
        D = d["mel"] if i == 0 else H
        shapes += [(f"lstm_{i}", "w_ih", (D, 4 * H)), (f"lstm_{i}", "w_hh", (H, 4 * H)),
                   (f"lstm_{i}", "b", (4 * H,))]
    shapes += [("projection", "kernel", (H, E)), ("projection", "bias", (E,))]
    total = sum(math.prod(s) for *_, s in shapes)
    flat = torch.empty(total, device=device).uniform_(
        -1.0, 1.0, generator=voices.generator(seed, 101, device)) / math.sqrt(H)
    tree, at = {}, 0
    for layer, name, s in shapes:
        n = math.prod(s)
        tree.setdefault(layer, {})[name] = flat[at:at + n].view(s)
        at += n
    return tree


def module_names(d: dict) -> dict:
    """The program's GE2E parameter names -> (tree layer, leaf)."""
    names = {f"lstm.{i}.{leaf}": (f"lstm_{i}", leaf)
             for i in range(d["layers"]) for leaf in ("w_ih", "w_hh", "b")}
    names.update({"projection.kernel": ("projection", "kernel"),
                  "projection.bias": ("projection", "bias")})
    return names


@torch.no_grad()
def load(module, tree: dict, d: dict) -> None:
    params = dict(module.named_parameters())
    for name, (layer, leaf) in module_names(d).items():
        params[name].copy_(tree[layer][leaf])


def crop_batch(seed: int, index: int, n_speakers: int, m_utts: int, frames: int, snd: dict,
               device) -> torch.Tensor:
    """(N M, frames, mel) mel crops, rows grouped by speaker: N voices of
    this batch, M utterances each, each exactly ``frames`` frames long."""
    gen = voices.generator(seed, 1000 + index, device)
    spk = voices.speakers(gen, n_speakers, device)
    who = torch.arange(n_speakers, device=device).repeat_interleave(m_utts)
    n = (frames - 1) * snd["Frame_Shift"]
    wav = voices.render(gen, spk, who, torch.full_like(who, n), n, snd["Sample_Rate"])
    return rdsp.melspectrogram(wav, snd)
