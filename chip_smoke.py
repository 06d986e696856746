#!/usr/bin/env python3
"""Smoke-test the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

1. Builds the four hand-written kernels of ``multi_speaker_tts_tpu_torch``
   from ``csrc/`` (one ``nvcc`` per source, all started together).
2. Main path: ``Synthesizer.from_compact("demo/serving_ckpt_full.msgpack")``
   with ``Linear_Head.Use: false`` (the mel-only configuration at full
   width) on ``cuda``; enrolls the three ``demo/enroll_*.wav`` and
   synthesizes four texts in one batch as 16-bit PCM. The launch counters
   are zeroed just before and read just after; every kernel must have
   launched. The wavs must be finite int16 and every mel length > 0, and
   the enrollment embedding must agree with the port's plain CPU path.
   The same enroll + synthesize (same dropout draws) then runs under
   ``torch.profiler``: its device busy time over the unprofiled pass's
   wall time gives the device's idle share.
3. Kernel phase: each kernel's wrapper is called again on the exact
   inputs the main path gave it (recorded during step 2), held against its
   plain PyTorch version on the card with a stated tolerance, and timed
   with CUDA events beside the plain version and, where one PyTorch call
   computes the same function, that call (timed only; the port never
   calls it).
4. Prints one ``{"kernels": [...]}`` line, the card's name and power limit
   from nvidia-smi, and as the last line
   ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
   the last line.

TF32 is switched off for matmuls and cuDNN (``allow_tf32 = False``), so
every f32 product in the plain versions runs in full f32.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
CKPT = ROOT / "demo" / "serving_ckpt_full.msgpack"
ENROLL = [ROOT / "demo" / f for f in
          ("enroll_spk0_utt0.wav", "enroll_spk0_utt1.wav", "enroll_spk5_utt0.wav")]
TEXTS = [
    "hello world, this is a test of the port.",
    "the quick brown fox jumps over the lazy dog.",
    "zero shot speaker cloning on one card.",
    "griffin lim turns the mel back into sound.",
]
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32 CUDA-core
# and bf16 tensor-core FLOP/s.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _time_ms(fn, warmup: int, reps: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _record(module, name: str, store: list) -> None:
    """Wrap ``module.name`` so every call's arguments are kept."""
    original = getattr(module, name)

    def recorded(*args, **kwargs):
        store.append((args, kwargs))
        return original(*args, **kwargs)

    setattr(module, name, recorded)
    recorded.original = original


def _bound_ms(n_bytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BPS, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _profile(synth, wavs) -> tuple[float, list[int]]:
    """One enroll + synthesize under torch.profiler: device busy time (the
    union of CUDA kernel and copy intervals), its share of the profiled
    wall time, the host time of the port's stage spans, and the kernels by
    device time. A first, empty profile takes the profiler's start-up cost.
    Returns the busy ms and the mel lengths (the caller reseeds the
    dropout generator so this pass repeats the unprofiled one's work)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        torch.ones(1, device="cuda").sum().item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        emb = synth.enroll(wavs)
        out = synth.synthesize(TEXTS, emb, pcm16=True)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stages = ("enroll.", "synth.")
    spans, intervals, by_kernel = {}, [], {}
    for e in prof.events():
        if e.name.startswith(stages):
            if e.device_type == DeviceType.CPU:
                spans[e.name] = spans.get(e.name, 0.0) + e.cpu_time_total / 1e3
        elif e.device_type == DeviceType.CUDA:
            intervals.append((e.time_range.start, e.time_range.end))
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    busy_ms = busy_us / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile (under the profiler): wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%, {len(intervals)} device ops")
    print("profile stage spans (host ms): "
          + json.dumps({k: round(v, 2) for k, v in sorted(spans.items())}))
    print("profile top device ops (ms): "
          + json.dumps([[k[:70], round(v, 3)] for k, v in top]))
    return busy_ms, [item["mel_length"] for item in out]


def main() -> int:
    if not (ROOT / "multi_speaker_tts_tpu_torch").is_dir() or not CKPT.exists():
        _fail(f"run from a checkout of the repository ({ROOT} lacks the port)")
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = "
          "torch.backends.cudnn.allow_tf32 = False")

    from multi_speaker_tts_tpu_torch.audio import wav_io
    from multi_speaker_tts_tpu_torch.checkpoints import load_compact
    from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.ops import (
        _build, birnn_kernel, griffin_lim_staged, lstm_kernel, mel_kernel,
    )

    kernels = {
        "mel_frontend": mel_kernel.KERNEL,
        "ge2e_lstm_layer": lstm_kernel.KERNEL,
        "text_encoder_bilstm": birnn_kernel.KERNEL,
        "griffin_lim_staged": griffin_lim_staged.KERNEL,
    }

    # 1. Build ---------------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build([k.source for k in kernels.values()])
    print(f"build: {len(reports)} sources compiled in {time.perf_counter() - t0:.1f} s")
    for src, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    # 2. Main path -----------------------------------------------------------
    params, batch_stats, meta = load_compact(CKPT)
    hp = Recursive_Parse(meta["hp"]).replace(Linear_Head={"Use": False})
    synth = Synthesizer(hp, params, batch_stats, seed=0)  # device None -> cuda
    wavs = [wav_io.load_wav(p, target_sr=hp.Sound.Sample_Rate)[0] for p in ENROLL]

    recorded = {name: [] for name in kernels}
    _record(mel_kernel, "melspectrogram_kernel", recorded["mel_frontend"])
    _record(lstm_kernel, "lstm_seq_layer_kernel", recorded["ge2e_lstm_layer"])
    _record(birnn_kernel, "bilstm_recurrence_kernel", recorded["text_encoder_bilstm"])
    _record(griffin_lim_staged, "griffin_lim_staged_kernel", recorded["griffin_lim_staged"])

    # Warm-up pass at the counted pass's shapes (loads the libraries, packs
    # the weights, picks the cuBLAS kernels, grows the allocator's pool),
    # then the counted pass.
    synth.synthesize(TEXTS, synth.enroll(wavs), pcm16=True)
    for store in recorded.values():
        store.clear()
    for k in kernels.values():
        k.launches = 0
    synth.generator.manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = synth.enroll(wavs)
    torch.cuda.synchronize()
    t_enroll = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = synth.synthesize(TEXTS, emb, pcm16=True)
    torch.cuda.synchronize()
    t_synth = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"main path launches: {launches}")

    failures = []
    for name, n in launches.items():
        if n == 0:
            failures.append(f"kernel {name} was not launched on the main path")
    audio_s = 0.0
    for i, item in enumerate(out):
        wav = item["wav"]
        if wav.dtype.name != "int16" or wav.ndim != 1 or wav.size == 0:
            failures.append(f"utterance {i}: wav {wav.dtype} {wav.shape}")
        if item["mel_length"] <= 0:
            failures.append(f"utterance {i}: mel_length {item['mel_length']}")
        if not (abs(wav.astype("int64")).max() > 0):
            failures.append(f"utterance {i}: silent wav")
        audio_s += wav.size / hp.Sound.Sample_Rate
    mel_lengths = [item["mel_length"] for item in out]
    print(f"enroll: {len(wavs)} wavs in {t_enroll * 1e3:.1f} ms; synthesize: "
          f"{len(TEXTS)} texts, mel_lengths {mel_lengths}, decode bucket "
          f"{synth.last_decode_bucket}, {audio_s:.2f} s of audio in "
          f"{t_synth * 1e3:.1f} ms = {audio_s / t_synth:.2f}x real time")

    # The same enrollment through the port's plain path on the CPU.
    cpu = Synthesizer(hp, params, batch_stats, device="cpu")
    emb_cpu = cpu.enroll(wavs)
    cos = float((emb * emb_cpu).sum())
    print(f"enroll embedding: card vs plain CPU cosine {cos:.6f}")
    if not math.isfinite(cos) or cos < 0.999:
        failures.append(f"card embedding disagrees with the plain CPU path: cos {cos}")

    # Where the time goes: the same enroll + synthesize again (same dropout
    # draws) under the profiler (spans from the port's record_function
    # labels; device time summed over CUDA kernels). The idle share of the
    # unprofiled pass is its wall time less this device busy time.
    synth.generator.manual_seed(0)
    busy_ms, prof_lengths = _profile(synth, wavs)
    wall_ms = (t_enroll + t_synth) * 1e3
    print(f"device idle, unprofiled pass: busy {busy_ms:.1f} ms (profiled repeat, mel_lengths "
          f"{prof_lengths}) of {wall_ms:.1f} ms wall = {100 * (1 - busy_ms / wall_ms):.1f}% idle")
    if prof_lengths != mel_lengths:
        print(f"  (the profiled repeat decoded {prof_lengths}, the unprofiled pass "
              f"{mel_lengths}: the idle share above is approximate)")

    # 3. Kernel phase --------------------------------------------------------
    rows = []

    def check(name, replaces, source, kernel_fn, plain_fn, err_fn, tol,
              bound, library_fn=None, warmup=3, reps=20, also=()):
        """Error over the timed inputs and the ``also`` (kernel_fn,
        plain_fn) pairs of other main-path shapes; times at the first."""
        errs = []
        for k_fn, p_fn in ((kernel_fn, plain_fn), *also):
            got, ref = k_fn(), p_fn()
            torch.cuda.synchronize()
            errs.append(float(err_fn(got, ref)))
        err = max(errs)
        ok = all(math.isfinite(e) for e in errs) and err <= tol
        print(f"{name}: max_abs_err {err:.3e} over {len(errs)} shape(s) "
              f"{[f'{e:.3e}' for e in errs]} (tolerance {tol:.1e}) {'ok' if ok else 'FAILED'}")
        if not ok:
            failures.append(f"{name}: error {err} > {tol}")
        bound_ms, bound_by = bound
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "tolerance": tol,
            "ms": _time_ms(kernel_fn, warmup, reps),
            "plain_ms": _time_ms(plain_fn, 1, max(1, reps // 4)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if library_fn is None else _time_ms(library_fn, warmup, reps),
        })

    def max_abs(a, b):
        if isinstance(a, tuple):
            return max(max_abs(x, y) for x, y in zip(a, b))
        return (a.float() - b.float()).abs().max().item()

    # Mel front-end: (1, L + n_fft) padded signal -> (1, T, 80), f32.
    (y_pad, T, cfg), _ = recorded["mel_frontend"][0]
    B, Lp = y_pad.shape
    F_bins = cfg.n_fft // 2 + 1
    check(
        "mel_frontend", "multi_speaker_tts_tpu/ops/mel_kernel.py:151",
        "multi_speaker_tts_tpu_torch/csrc/mel.cu",
        lambda: mel_kernel.melspectrogram_kernel.original(y_pad, T, cfg),
        lambda: mel_kernel.melspectrogram_plain(y_pad, T, cfg),
        max_abs, 1e-4,
        _bound_ms(4 * (B * Lp + cfg.n_fft * F_bins * 2 + F_bins * cfg.n_mels + B * T * cfg.n_mels),
                  B * T * (4 * cfg.n_fft * F_bins + 3 * F_bins + 2 * F_bins * cfg.n_mels),
                  F32_FLOPS),
    )

    # GE2E LSTM layer, timed at the 768-wide layers' shape (layer 1 of the
    # stack); its error also covers layer 0's (D = mel bins) shape.
    (p, x_tm), _ = next(r for r in recorded["ge2e_lstm_layer"] if r[0][1].shape[-1] != 80)
    (p0, x0), _ = next(r for r in recorded["ge2e_lstm_layer"] if r[0][1].shape[-1] == 80)
    Tl, Bl, Dl = x_tm.shape
    Hl = p.hidden_size
    lstm_lib = torch.nn.LSTM(Dl, Hl).to(device=x_tm.device, dtype=torch.bfloat16)
    with torch.no_grad():
        lstm_lib.weight_ih_l0.copy_(p.w_ih.t())
        lstm_lib.weight_hh_l0.copy_(p.w_hh.t())
        lstm_lib.bias_ih_l0.copy_(p.b)
        lstm_lib.bias_hh_l0.zero_()
    lstm_lib.flatten_parameters()
    check(
        "ge2e_lstm_layer", "multi_speaker_tts_tpu/ops/lstm_pallas.py:108",
        "multi_speaker_tts_tpu_torch/csrc/lstm.cu",
        lambda: lstm_kernel.lstm_seq_layer_kernel.original(p, x_tm),
        lambda: lstm_kernel.lstm_seq_layer_plain(p, x_tm, torch.bfloat16),
        max_abs, 5e-3,
        _bound_ms(2 * (Tl * Bl * Dl + 4 * Hl * (Dl + Hl) + Tl * Bl * Hl) + 4 * (4 * Hl + 2 * Bl * Hl),
                  2 * Tl * Bl * 4 * Hl * (Dl + Hl), BF16_FLOPS),
        library_fn=lambda: lstm_lib(x_tm),
        also=[(lambda: lstm_kernel.lstm_seq_layer_kernel.original(p0, x0),
               lambda: lstm_kernel.lstm_seq_layer_plain(p0, x0, torch.bfloat16))],
    )

    # Text-encoder BiLSTM recurrence on the hoisted gates.
    (gxf, gxb, whf, whb), _ = recorded["text_encoder_bilstm"][0]
    Sb, Bb, H4 = gxf.shape
    Hb = H4 // 4
    bi_lib = torch.nn.LSTM(2 * H4, Hb, bidirectional=True).to(device=gxf.device,
                                                             dtype=torch.bfloat16)
    eye = torch.eye(H4, device=gxf.device)
    zero = torch.zeros_like(eye)
    with torch.no_grad():  # identity input weights: the gates are the input
        bi_lib.weight_ih_l0.copy_(torch.cat([eye, zero], dim=1))
        bi_lib.weight_ih_l0_reverse.copy_(torch.cat([zero, eye], dim=1))
        bi_lib.weight_hh_l0.copy_(whf.t())
        bi_lib.weight_hh_l0_reverse.copy_(whb.t())
        for bias in (bi_lib.bias_ih_l0, bi_lib.bias_hh_l0,
                     bi_lib.bias_ih_l0_reverse, bi_lib.bias_hh_l0_reverse):
            bias.zero_()
    bi_lib.flatten_parameters()
    gx_cat = torch.cat([gxf, gxb], dim=-1)
    check(
        "text_encoder_bilstm", "multi_speaker_tts_tpu/ops/birnn_pallas.py:161",
        "multi_speaker_tts_tpu_torch/csrc/bilstm.cu",
        lambda: birnn_kernel.bilstm_recurrence_kernel.original(gxf, gxb, whf, whb),
        lambda: birnn_kernel.bilstm_recurrence_plain(gxf, gxb, whf, whb, torch.bfloat16),
        max_abs, 5e-3,
        _bound_ms(2 * (2 * Sb * Bb * H4 + 2 * H4 * Hb + 2 * Sb * Bb * Hb),
                  2 * 2 * Sb * Bb * H4 * Hb, BF16_FLOPS),
        library_fn=lambda: bi_lib(gx_cat),
    )

    # Staged Griffin-Lim: (B, T, 640) bf16 magnitudes -> (B, hop * (T - 1)).
    (mag_staged, hop, n_iter), _ = recorded["griffin_lim_staged"][0]
    Bg, Tg, G = mag_staged.shape

    def rel_err(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp(min=1e-9)).item()

    check(
        "griffin_lim_staged", "multi_speaker_tts_tpu/ops/griffin_lim_staged.py:254",
        "multi_speaker_tts_tpu_torch/csrc/griffin_lim.cu",
        lambda: griffin_lim_staged.griffin_lim_staged_kernel.original(mag_staged, hop, n_iter),
        lambda: griffin_lim_staged.griffin_lim_staged_plain(mag_staged, hop, n_iter,
                                                            torch.bfloat16),
        rel_err, 2e-2,
        _bound_ms(2 * Bg * Tg * G + 4 * Bg * (Tg - 1) * hop + 2 * 5 * 4 * 256 * 128,
                  (n_iter + 0.5) * Bg * Tg * 32 * 2 * 128 * 128, BF16_FLOPS),
        warmup=1, reps=5,
    )
    for row in rows:
        if row["name"] == "griffin_lim_staged":
            row["error_metric"] = "max |kernel - plain| / max |plain|"

    # 4. Report --------------------------------------------------------------
    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
          f"nvidia-smi unavailable: {smi.stderr.strip()}")
    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
