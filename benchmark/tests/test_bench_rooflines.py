"""The yardstick's counts against shapes worked by hand."""

import math

import pytest

from benchmark.harness import peaks
from benchmark.rooflines import decode, griffin_lim_staged, lstm_bwd, lstm_fwd, mel, models

GE2E = {"mel": 80, "H": 768, "layers": 3, "E": 256}
SOUND = {"Sample_Rate": 22050, "Frame_Length": 1024, "Frame_Shift": 256, "Mel_Dim": 80,
         "Mel_F_Min": 0, "Mel_F_Max": None, "Griffin_Lim_Iter": 60, "Spectrogram_Dim": 513}
HP = {"Sound": SOUND,
      "Decoder": {"N_Frames_Per_Step": 2, "Prenet": {"Sizes": [256, 256]},
                  "LSTM": {"Sizes": 1024}, "Attention": {"Size": 128,
                                                        "Conv": {"Channels": 32, "Kernel_Size": 31}},
                  "Early_Exit_Chunk": 16},
      "Encoder": {"LSTM_Size": 512}, "Speaker_Embedding": {"Embedding_Size": 256}}


def test_ge2e_train_step_is_7_4_tflop():
    # 3 x the forward: per row-step 2 x 4 x 768 x ((80 + 768) + 2 x 1536), over
    # 160 steps, plus the projection, over 640 rows.
    per_row = 160 * (2 * 4 * 768 * 848 + 2 * 2 * 4 * 768 * 1536) + 2 * 768 * 256
    assert models.ge2e_forward(GE2E, 160) == per_row
    assert 3 * 640 * per_row == pytest.approx(7.3995e12, rel=1e-4)


def test_lstm_bounds():
    T, B, D, H = 160, 640, 80, 768
    flops = 2 * T * B * 4 * H * (D + H)
    n_bytes = 2 * (T * B * D + 4 * H * (D + H) + T * B * H + T * B * 5 * H) + 4 * (4 * H + 2 * B * H)
    assert lstm_fwd.layer_bound_s(T, B, D, H, True) == max(flops / 989e12, n_bytes / 3.35e12)
    assert lstm_fwd.stack_bound_s(GE2E, T, B, False) == pytest.approx(
        sum(lstm_fwd.layer_bound_s(T, B, d, H, False) for d in (80, 768, 768)))
    # The backward at 640 rows is bound by its bytes: bf16 gates, f32 cells,
    # W_hh, f32 gate cotangents out, f32 upstream cotangents and dh_T.
    bwd_bytes = (2 * T * B * 4 * H + 4 * T * B * H + 2 * 4 * H * H + 4 * T * B * 4 * H
                 + 4 * T * B * H + 4 * B * H)
    assert lstm_bwd.layer_bound_s(T, B, H) == pytest.approx(bwd_bytes / 3.35e12)
    assert bwd_bytes / 3.35e12 > 2 * T * B * 4 * H * H / 989e12


def test_decode_row_step():
    prenet = 2 * (80 * 256 + 256 * 256)
    gates = 2 * 4 * 1024 * ((256 + 768 + 1024) + (1024 + 768 + 1024))
    attention = 2 * 1024 * 128 + 64 * (2 * 31 * 2 * 32 + 2 * 32 * 128 + 2 * 128) + 2 * 64 * 768
    proj = 2 * 1792 * 161
    assert decode.row_step_flops(decode.widths(HP), 64) == prenet + gates + attention + proj


def test_decode_counts_rows_still_decoding():
    w = decode.widths(HP)
    one = {"S": 64, "steps": [10], "n_steps": 200}
    two = {"S": 64, "steps": [10, 1], "n_steps": 200}
    # K = 10 (the largest divisor of 200 up to 16): one chunk either way,
    # the second row adds one step's work and its inputs only.
    assert decode.chunk_steps(200, 16) == 10
    fl = decode.row_step_flops(w, 64)
    assert decode.batch_bound_s(HP, one) == pytest.approx(
        max(10 * fl / 989e12, (decode.weight_bytes(w) + 4 * 64 * (128 + 768 + 1) + 10 * 4 * (161 + 64))
            / 3.35e12))
    assert decode.batch_bound_s(HP, two) > decode.batch_bound_s(HP, one)
    three = {"S": 64, "steps": [25], "n_steps": 200}
    assert decode.batch_bound_s(HP, three) > 2 * decode.batch_bound_s(HP, one)


def test_griffin_lim_and_mel():
    b = {"frames": [100, 50]}
    assert griffin_lim_staged.batch_bound_s(HP, b) == pytest.approx(60.5 * 150 * 1024 ** 2 / 989e12)
    t = mel.bound(SOUND, 64, 1 << 19, 2049)
    assert t >= 4 * 64 * (1 << 19) / peaks.HBM_BYTES_PER_S
    assert t >= 64 * 2049 * (1024 + 5 * 512 * math.log2(512)) / peaks.F32_FLOPS


def test_synth_model_counts_grow_with_work():
    batch = {"S": 64, "steps": [50, 60], "frames": [100, 120]}
    more = {"S": 64, "steps": [50, 70], "frames": [100, 140]}
    full_hp = dict(HP, Encoder={"LSTM_Size": 512, "Embedding_Size": 512,
                                "Conv": {"Channels": 512, "Kernel_Size": 5, "Stacks": 3}},
                   Postnet={"Conv": {"Channels": 512, "Kernel_Size": 5, "Stacks": 5}},
                   Linear_Head={"CBHG": {"Bank_K": 8, "Bank_Channels": 128,
                                         "Projection_Channels": 256, "GRU_Size": 256,
                                         "Highway": {"Size": 128, "Layers": 4}}})
    a = models.synth_batch(full_hp, batch, [40, 50])
    assert models.synth_batch(full_hp, more, [40, 50]) > a > 220 * 60.5 * 1024 ** 2
