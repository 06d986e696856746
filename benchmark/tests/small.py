"""Small sizes of the cells for CPU tests: the same drivers, the
configurations' widths cut, the traffic shortened, and limits of their own:
at these widths a leaf or a frame holds few values, so the program's plain
bf16 path reads further from the f32 reference than the full size does on
the card (readings at these sizes, three seeds: the synthesis median row's
frame RMS up to 8.6e-4, its control 5.9e-3, its stop RMS up to 6.6e-3, the
int8 decode's 2.8e-2; GE2E training's worst gradient leaf 1.2e-2, its
control 2.0e-2)."""

SYNTH = {"params": {"batch": 2, "tokens_min": 8, "tokens_max": 12, "warmup_batches": 1,
                    "keep_every": 2, "check_batches": 2},
         "hp": {"Sound": {"Griffin_Lim_Iter": 2}},
         "limits": {"enroll_gap": 0.05, "frame_med": 0.003, "stop_med": 0.015,
                    "align_row": 0.003, "postnet_med": 1e-3, "linear_row": 0.003,
                    "vocode_row": 1e-3, "vocode_rerun_gap": 0.0}}
GE2E_HP = {"Speaker_Embedding": {"GE2E": {"LSTM": {"Sizes": 32}, "Window_Length": 24,
                                          "Window_Shift": 12}},
           "GE2E_Train": {"Batch_Speakers": 4, "Batch_Utterances": 3, "Frame_Length": 24}}
TRAIN = {"params": {"pool_batches": 4}, "hp": GE2E_HP,
         "limits": {"loss_gap": 5e-5, "grad_gap": 0.016, "update_gap": 0.012}}
EMBED = {"params": {"batch": 4, "seconds_min": 0.5, "seconds_max": 1.0,
                    "speakers_per_batch": 2, "pool_batches": 2, "check_batches": 2},
         "hp": GE2E_HP, "limits": {"embed_gap": 4e-3}}
SIZES = {"synth.b32-short": SYNTH, "ge2e_train.n64m10": TRAIN, "ge2e_embed.b64": EMBED}


def run(cell_name: str, seconds: float = 1.0, trace: bool = False, control: bool = False,
        seed: int = (1 << 31) + 7, **overrides):
    import time

    import torch

    from benchmark.harness import runner
    from benchmark.harness.cell import Cell, Context

    torch.manual_seed(0)
    ctx = Context(Cell.by_name(cell_name), seed, seconds, trace, device="cpu",
                  overrides={**SIZES[cell_name], **overrides}, control=control)
    return runner.execute(ctx, time.perf_counter())
