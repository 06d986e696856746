"""Time one checkout's mel and BiGRU-backward kernels on the inputs its main
path gives them, and the device busy time of the paths that launch them.

The tool enrolls the three demo wavs (``Synthesizer.enroll``, which launches
the mel front-end once a wav) and takes one ``Trainer.train_step`` on a batch
of 32 made from the five demo wavs (one BiGRU-backward launch), keeping the
inputs each wrapper was given. If ``--inputs PATH`` exists, the kernels are
timed on the inputs kept there instead, so that two checkouts are timed on
the same inputs; otherwise this run's inputs are written there. It prints one
JSON line:

- ``mel_ms`` and ``bigru_bwd_ms``: each kernel's wrapper (CUDA events, the
  card held ahead so that the events time the card's work), with its error
  against its plain version;
- ``enroll_busy_ms`` and ``train_step_busy_ms``: the device busy time (the
  union of the card's kernel and copy intervals under ``torch.profiler``) of
  the enrollment and of one train step; ``train_step_ms`` the step's mean
  time over three steps (CUDA events);
- ``synth_ms``: the median wall time (host clock to a synchronised card) of
  ten ``synthesize`` calls of the two texts with the default decode, and
  ``synth_ms_all`` the ten;
- ``seeded_ms``: the production-width kernels on seeded inputs at the shapes
  of ``chip_smoke.py``'s rows (the card's work alone, the median of three
  timings): the mel front-end's two routes, the GE2E layer's forward in
  both modes and its backward, the BiLSTM's forward and backward, the BiGRU
  backward, the BiGRU forward in both modes, a K 10 decode chunk in both
  modes, the dense Griffin-Lim at n_fft 1024 (B 4, T 128, 60 iterations)
  and 2048, and the wide BiGRU at H 256 in its three modes.

``--repo DIR`` measures another checkout's package and kernel sources (for
example the parent commit's, unpacked with ``git archive``); run the file by
its path then, so that the package is imported from ``DIR``. To compare two
checkouts, run them in turns on one card (parent, change, change, parent)::

    python multi_speaker_tts_tpu_torch/tools/kernel_ab.py --repo _archive/parent \\
        --inputs _archive/ab_inputs.pt --label parent
    python multi_speaker_tts_tpu_torch/tools/kernel_ab.py \\
        --inputs _archive/ab_inputs.pt --label change

The demo checkpoint and wavs are read from the checkout holding this file.
Nothing here runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[2]
DEMO = HERE / "demo"
ENROLL = ("enroll_spk0_utt0.wav", "enroll_spk0_utt1.wav", "enroll_spk5_utt0.wav")
TRAIN_WAVS = ENROLL + ("clone_spk0.wav", "clone_spk5.wav")
TEXTS = ("hello world, this is a test of the port.",
         "the quick brown fox jumps over the lazy dog.")
STAGES = ("enroll.", "synth.", "stream.")  # the port's span names
SM_CLOCK_HZ = 1.98e9  # H100 SXM boost clock: the spin that holds the card ahead


def time_ms(fn, warmup: int = 5, reps: int = 50, queue_ahead: bool = True) -> float:
    """Mean ms a call from CUDA events around ``reps`` calls; ``queue_ahead``
    first holds the card in a 20 ms spin, so that the events time the card's
    work alone, also for calls shorter than their host-side dispatch."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if queue_ahead:
        torch.cuda._sleep(int(0.02 * SM_CLOCK_HZ))
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def busy_ms(fn) -> float:
    """The device busy time of ``fn()`` under torch.profiler: the union of
    its CUDA kernel and copy intervals, without the device-side ranges of
    the port's stage spans (``enroll.*``, ``synth.*``, ``stream.*``), which
    cover the gaps between their kernels. A first, empty profile takes the
    profiler's start-up cost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        torch.ones(1, device="cuda").sum().item()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.name.startswith(STAGES))
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy_us / 1e3


def train_batch(hp, n: int = 32) -> dict:
    """A batch of ``n`` in the ``collate_tts`` layout at the checkpoint's first
    buckets: the five demo wavs cycled, mel and linear targets from the
    port's front-end on the CPU, reference crops from a seeded generator."""
    import numpy as np
    import torch

    from multi_speaker_tts_tpu_torch.audio import dsp, wav_io
    from multi_speaker_tts_tpu_torch.data.collate import collate_tts
    from multi_speaker_tts_tpu_torch.text import encode_text

    cfg = dsp.DSPConfig.from_hp(hp)
    feats = []
    for name in TRAIN_WAVS:
        wav = torch.from_numpy(wav_io.load_wav(DEMO / name, target_sr=hp.Sound.Sample_Rate)[0])
        feats.append((dsp.melspectrogram(wav, cfg).numpy(), dsp.spectrogram(wav, cfg).numpy()))
    pats = [{"Tokens": encode_text(TEXTS[i % len(TEXTS)], hp), "Mel": feats[i % 5][0],
             "Spect": feats[i % 5][1], "Speaker_ID": i % 5} for i in range(n)]
    buckets = hp.Train.Batch_Bucketing
    return collate_tts(pats, buckets.Token_Buckets[0], buckets.Mel_Buckets[0], hp.Sound.Mel_Dim,
                       int(hp.Decoder.N_Frames_Per_Step), hp.Speaker_Embedding.GE2E.Window_Length,
                       np.random.default_rng(0), hp.Sound.Spectrogram_Dim)


def seeded_ms() -> dict:
    """``seeded_ms`` of the JSON line (the module docstring): inputs from a
    seeded generator, weights at a trained model's scale for the decode."""
    import numpy as np
    import torch

    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel, lstm_kernel, mel_kernel
    from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk
    from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan
    from multi_speaker_tts_tpu_torch.ops.gru import GRUParams
    from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams

    rng = np.random.default_rng(0)

    def t(*shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32)).cuda()

    def ms(fn):
        return statistics.median(time_ms(fn, 3, 20) for _ in range(3))

    out = {}
    for n_fft, hop, T in ((1024, 256, 133), (800, 200, 100)):
        cfg = dsp.DSPConfig(22050, n_fft, hop, 80, 0.0, None, 0.97, -100.0, 20.0, 1.5, 60)
        y = t(1, (T - 1) * hop + n_fft, s=0.3)
        out[f"mel_{n_fft}"] = ms(lambda: mel_kernel.melspectrogram_kernel(y, T, cfg))
    p = LSTMParams(t(768, 3072, s=0.1), t(768, 3072, s=0.1), t(3072, s=0.1))
    x = t(64, 32, 768).to(torch.bfloat16)
    _, _, _, g, c = lstm_kernel.lstm_seq_layer_kernel(p, x, save_residuals=True)
    dys = t(64, 32, 768)
    out["lstm_fwd_residuals"] = ms(lambda: lstm_kernel.lstm_seq_layer_kernel(p, x, True))
    out["lstm_bwd"] = ms(lambda: lstm_kernel.lstm_seq_layer_bwd_kernel(p.w_hh, g, c, None, dys))
    pf, pb = (LSTMParams(t(512, 1024, s=0.1), t(256, 1024, s=0.1), t(1024, s=0.1))
              for _ in range(2))
    gxf, gxb = birnn_kernel.bilstm_hoist(pf, pb, t(32, 64, 512), torch.bfloat16)
    res = birnn_kernel.bilstm_recurrence_kernel(gxf, gxb, pf.w_hh, pb.w_hh, True)[2:]
    dyf, dyb = t(64, 32, 256), t(64, 32, 256)
    out["bilstm_bwd"] = ms(lambda: birnn_kernel.bilstm_bwd_kernel(*res, pf.w_hh, pb.w_hh, dyf, dyb))
    gf, gb = (GRUParams(t(128, 384, s=0.1), t(128, 384, s=0.1), t(384, s=0.1), t(384, s=0.1))
              for _ in range(2))
    for label, B, T in (("bigru", 4, 400), ("bigru_residuals", 32, 132)):
        hf, hb = birnn_kernel.bigru_hoist(gf, gb, t(B, T, 128), torch.bfloat16)
        keep = label != "bigru"
        out[label] = ms(lambda: birnn_kernel.bigru_recurrence_kernel(hf, hb, gf, gb, keep))
    r = birnn_kernel.bigru_recurrence_kernel(hf, hb, gf, gb, True)
    args = (hf, r[2], r[3], hb, r[4], r[5], gf.w_hh, gb.w_hh, t(132, 32, 128), t(132, 32, 128))
    out["bigru_bwd"] = ms(lambda: birnn_kernel.bigru_bwd_kernel(*args))
    H, D, P, A, mel, rr, B, S, K = 1024, 768, 256, 128, 80, 2, 4, 48, 10
    w = lambda *shape, s=0.02: t(*shape, s=s)  # noqa: E731
    dp = dscan.DecoderParams(
        lstm=(LSTMParams(w(P + D, 4 * H), w(H, 4 * H), w(4 * H)),
              LSTMParams(w(H + D, 4 * H), w(H, 4 * H), w(4 * H))),
        attention=dscan.AttentionParams(w(H, A), w(31, 2, 32, s=0.3), w(32, A, s=0.3),
                                        w(A, 1, s=0.3)),
        frame_proj=(w(H + D, mel * rr), w(mel * rr)), stop_proj=(w(H + D, 1), w(1)))
    prenet = [(w(mel, P, s=0.2), w(P)), (w(P, P, s=0.2), w(P))]
    keys, memory = w(B, S, A, s=0.3), w(B, S, D, s=0.3)
    masks = [torch.from_numpy(rng.random((K, B, P)) < 0.5).cuda().float() / 0.5 for _ in range(2)]
    carry = dscan.initial_carry(B, memory, 2, H)
    ones, prev = torch.ones(B, S, device="cuda"), torch.zeros(B, mel, device="cuda")
    for mode, q in (("bf16", False), ("int8", True)):
        bundle = dk.prepare_bundle(dp, prenet, quantize=q)
        out[f"decode_{mode}"] = ms(lambda: dk.decode_segment_kernel(
            bundle, keys, memory, ones, carry, prev, *masks, K, mel, rr))
    out["lstm_fwd"] = ms(lambda: lstm_kernel.lstm_seq_layer_kernel(p, x))
    out["bilstm_fwd"] = ms(lambda: birnn_kernel.bilstm_recurrence_kernel(gxf, gxb, pf.w_hh,
                                                                         pb.w_hh))
    # The dense Griffin-Lim at pass (f)'s production size and at 2048 / 256,
    # and the wide BiGRU at H 256 (its resident build), all three modes.
    from multi_speaker_tts_tpu_torch.ops import griffin_lim_kernel as gk

    for n_fft, hop, B, T, n_iter in ((1024, 256, 4, 128, 60), (2048, 256, 2, 100, 8)):
        mag = t(B, T, n_fft // 2 + 1).abs()
        mp, mny = gk.split_magnitude(mag, n_fft)
        out[f"gl_dense_{n_fft}"] = ms(lambda: gk.griffin_lim_dense_kernel(mp, mny, n_fft, hop,
                                                                         n_iter))
    wf, wb = (GRUParams(t(128, 768, s=0.1), t(256, 768, s=0.0625), t(768, s=0.1),
                        t(768, s=0.1)) for _ in range(2))
    hf, hb = birnn_kernel.bigru_hoist(wf, wb, t(8, 200, 128), torch.bfloat16)
    out["bigru_wide_256"] = ms(lambda: birnn_kernel.bigru_recurrence_kernel(hf, hb, wf, wb))
    out["bigru_wide_256_residuals"] = ms(lambda: birnn_kernel.bigru_recurrence_kernel(
        hf, hb, wf, wb, True))
    r = birnn_kernel.bigru_recurrence_kernel(hf, hb, wf, wb, True)
    args = (hf, r[2], r[3], hb, r[4], r[5], wf.w_hh, wb.w_hh, t(200, 8, 256), t(200, 8, 256))
    out["bigru_wide_256_bwd"] = ms(lambda: birnn_kernel.bigru_bwd_kernel(*args))
    return out


def kept(module, name: str, store: list):
    """Wrap ``module.name`` so that every call's positional arguments are kept."""
    original = getattr(module, name)

    def wrapper(*args):
        store.append(args)
        return original(*args)

    setattr(module, name, wrapper)
    return original


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(HERE), help="the checkout to measure")
    ap.add_argument("--inputs", required=True,
                    help="the kernels' inputs: read if the file exists, else written")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    repo = pathlib.Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from multi_speaker_tts_tpu_torch.audio import dsp, wav_io
    from multi_speaker_tts_tpu_torch.checkpoints import load_compact
    from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.ops import _build, birnn_kernel, mel_kernel
    from multi_speaker_tts_tpu_torch.train.trainer import Trainer

    _build.build(sorted(p.name for p in _build.CSRC.glob("*.cu")))
    params, batch_stats, meta = load_compact(DEMO / "serving_ckpt_full.msgpack")
    hp = Recursive_Parse(meta["hp"])
    wavs = [wav_io.load_wav(DEMO / name, target_sr=hp.Sound.Sample_Rate)[0] for name in ENROLL]
    mel_calls, bwd_calls = [], []
    mel_fn = kept(mel_kernel, "melspectrogram_kernel", mel_calls)
    bwd_fn = kept(birnn_kernel, "bigru_bwd_kernel", bwd_calls)

    synth = Synthesizer(hp, params, batch_stats, seed=0)
    emb = synth.enroll(wavs)
    row = {"label": args.label, "repo": str(repo), "device": torch.cuda.get_device_name(0),
           "enroll_busy_ms": busy_ms(lambda: synth.enroll(wavs))}
    synth.synthesize(list(TEXTS), emb)
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        synth.synthesize(list(TEXTS), emb)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    row["synth_ms"], row["synth_ms_all"] = statistics.median(walls), walls
    del synth
    # A checkout from before Trainer.from_params took the weights in its constructor.
    make = getattr(Trainer, "from_params", Trainer)
    trainer = make(hp.replace(Speaker_Embedding={"GE2E": {"Freeze": False}}), params,
                   batch_stats, seed=0)
    batch = train_batch(hp)
    trainer.train_step(batch)
    row["train_step_ms"] = time_ms(lambda: trainer.train_step(batch), 0, 3, queue_ahead=False)
    row["train_step_busy_ms"] = busy_ms(lambda: trainer.train_step(batch))
    mel_kernel.melspectrogram_kernel, birnn_kernel.bigru_bwd_kernel = mel_fn, bwd_fn

    inputs = pathlib.Path(args.inputs)
    if inputs.exists():
        saved = torch.load(inputs, map_location="cuda")
        y_pad, T, cfg_fields = saved["mel"]
        mel_args, bwd_args = (y_pad, T, dsp.DSPConfig(**cfg_fields)), saved["bigru_bwd"]
        row["inputs"] = f"read from {inputs} (written by {saved['label']})"
    else:
        mel_args, bwd_args = mel_calls[0], bwd_calls[-1]
        y_pad, T, cfg = mel_args
        torch.save({"mel": (y_pad, T, dataclasses.asdict(cfg)), "bigru_bwd": bwd_args,
                    "label": args.label}, inputs)
        row["inputs"] = f"this run's, written to {inputs}"

    def peak_rel(got, want):
        return max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                   for a, b in zip(got, want))

    row.update({
        "mel_shape": list(mel_fn(*mel_args).shape), "bigru_bwd_shape": list(bwd_args[0].shape),
        "mel_ms": time_ms(lambda: mel_fn(*mel_args)),
        "mel_max_abs_err": (mel_fn(*mel_args)
                            - mel_kernel.melspectrogram_plain(*mel_args)).abs().max().item(),
        "bigru_bwd_ms": time_ms(lambda: bwd_fn(*bwd_args)),
        "bigru_bwd_rel_peak_err": peak_rel(bwd_fn(*bwd_args),
                                           birnn_kernel.bigru_bwd_plain(*bwd_args)),
    })
    row["seeded_ms"] = seeded_ms()
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
