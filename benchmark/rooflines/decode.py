"""Bound of the decode kernel (``csrc/decode.cu``, #6) over one batch's
early-exit decode: one chunk of K steps after another until every row has
stopped, K the largest divisor of the decode's steps up to
``Early_Exit_Chunk``. A chunk reads every weight once (bf16 gate rows of
both LSTM layers, the prenet, attention and projection weights), each
row's keys, memory and mask once, and writes each step's frames, stop
logit and alignment; its operations are those of the rows still decoding
(a row counts up to and with its stop step). bf16 peak: the gate products
run on the tensor cores in bf16."""

from __future__ import annotations

import math

from benchmark.harness.peaks import BF16_FLOPS, bound_s


def widths(hp: dict) -> dict:
    dec, enc = hp["Decoder"], hp["Encoder"]
    return {"mel": hp["Sound"]["Mel_Dim"], "r": dec["N_Frames_Per_Step"],
            "pre": list(dec["Prenet"]["Sizes"]), "H": dec["LSTM"]["Sizes"],
            "Dm": enc["LSTM_Size"] + hp["Speaker_Embedding"]["Embedding_Size"],
            "A": dec["Attention"]["Size"], "C": dec["Attention"]["Conv"]["Channels"],
            "Kc": dec["Attention"]["Conv"]["Kernel_Size"], "chunk": dec["Early_Exit_Chunk"]}


def chunk_steps(n_steps: int, chunk: int) -> int:
    return max(k for k in range(1, min(chunk, n_steps) + 1) if n_steps % k == 0)


def row_step_flops(w: dict, S: int) -> float:
    H, Dm, A, C = w["H"], w["Dm"], w["A"], w["C"]
    sizes = [w["mel"], *w["pre"]]
    prenet = sum(2 * a * b for a, b in zip(sizes, sizes[1:]))
    gates = 2 * 4 * H * ((w["pre"][-1] + Dm + H) + (H + Dm + H))
    attention = 2 * H * A + S * (2 * w["Kc"] * 2 * C + 2 * C * A + 2 * A) + 2 * S * Dm
    proj = 2 * (H + Dm) * (w["mel"] * w["r"] + 1)
    return prenet + gates + attention + proj


def weight_bytes(w: dict) -> float:
    H, Dm, A, C = w["H"], w["Dm"], w["A"], w["C"]
    sizes = [w["mel"], *w["pre"]]
    n = (4 * H * ((w["pre"][-1] + Dm + H) + (H + Dm + H))
         + sum(a * b + b for a, b in zip(sizes, sizes[1:]))
         + H * A + C * A + w["Kc"] * 2 * C + A + (H + Dm) * (w["mel"] * w["r"] + 1))
    return 2 * n


def batch_bound_s(hp: dict, batch: dict) -> float:
    """Seconds: the sum of the chunks' bounds."""
    w = widths(hp)
    S, steps, n_steps = batch["S"], batch["steps"], batch["n_steps"]
    K = chunk_steps(n_steps, w["chunk"])
    n_chunks = min(math.ceil(max(steps) / K), n_steps // K)
    per_row_in = 4 * S * (w["A"] + w["Dm"] + 1)
    per_row_step_out = 4 * (w["mel"] * w["r"] + 1 + S)
    fl = row_step_flops(w, S)
    total = 0.0
    for c in range(n_chunks):
        alive_steps = sum(max(0, min(s, (c + 1) * K) - c * K) for s in steps)
        rows = sum(1 for s in steps if s > c * K)
        total += bound_s(weight_bytes(w) + rows * per_row_in + alive_steps * per_row_step_out,
                         alive_steps * fl, BF16_FLOPS)
    return total
