"""Model operations a cell's work needs, for the whole-step shares of the
bf16 peak (the ``mfu`` metrics): 2 operations a multiply-add of every
product the model defines, at each request's own lengths.

- GE2E (``ge2e_forward``): per window of T frames, each LSTM layer's input
  and recurrent products at every step, and the projection. A training
  step is 3x its forward (the forward, the backward to the inputs and to
  the weights) over the step's rows.
- Synthesis (``synth_batch``): the encoder's convolutions and BiLSTM over
  each row's tokens; the decoder (``decode.row_step_flops``) for each row's
  decoded steps; the postnet and the CBHG head (bank, projections,
  highways, BiGRU, linear projection) over each row's frames; Griffin-Lim's
  transform (n_iter + 0.5 forward-inverse pairs of n_fft^2) over each row's
  frames.
"""

from __future__ import annotations

from benchmark.rooflines import decode


def ge2e_forward(dims: dict, T: int) -> float:
    H = dims["H"]
    per_step = sum(2 * 4 * H * ((dims["mel"] if i == 0 else H) + H)
                   for i in range(dims["layers"]))
    return T * per_step + 2 * H * dims["E"]


def synth_batch(hp: dict, batch: dict, tokens: list[int]) -> float:
    enc, snd = hp["Encoder"], hp["Sound"]
    C, Kc, E = enc["Conv"]["Channels"], enc["Conv"]["Kernel_Size"], enc["Embedding_Size"]
    h = enc["LSTM_Size"] // 2
    per_token = (2 * Kc * E * C + (enc["Conv"]["Stacks"] - 1) * 2 * Kc * C * C
                 + 2 * 2 * 4 * h * (C + h))
    w = decode.widths(hp)
    mel = snd["Mel_Dim"]
    post = hp["Postnet"]["Conv"]
    pc, pk = post["Channels"], post["Kernel_Size"]
    per_frame = 2 * pk * (mel * pc + (post["Stacks"] - 2) * pc * pc + pc * mel)
    cb = hp["Linear_Head"]["CBHG"]
    Kb, Cb, Pc, Hw, G = (cb["Bank_K"], cb["Bank_Channels"], cb["Projection_Channels"],
                         cb["Highway"]["Size"], cb["GRU_Size"] // 2)
    per_frame += (sum(2 * k * mel * Cb for k in range(1, Kb + 1)) + 2 * 3 * Kb * Cb * Pc
                  + 2 * 3 * Pc * mel + 2 * mel * Hw + cb["Highway"]["Layers"] * 2 * 2 * Hw * Hw
                  + 2 * 2 * 3 * G * (Hw + G) + 2 * 2 * G * snd["Spectrogram_Dim"])
    n_fft = snd["Frame_Length"]
    per_frame += (snd["Griffin_Lim_Iter"] + 0.5) * n_fft * n_fft
    dec_steps = sum(batch["steps"])
    return (sum(tokens) * per_token + dec_steps * decode.row_step_flops(w, batch["S"])
            + sum(batch["frames"]) * per_frame)
