#!/usr/bin/env python3
"""Smoke-test the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

1. Builds the thirteen hand-written kernel sources of
   ``multi_speaker_tts_tpu_torch`` from ``csrc/`` and the barrier-only
   ``barrier_floor.cu`` (one ``nvcc`` per source, all started together).
2. Main path: ``demo/serving_ckpt_full.msgpack`` as it is (CBHG linear head
   on) on ``cuda``: enroll the three ``demo/enroll_*.wav`` and synthesize
   four texts in one batch as 16-bit PCM, three times: (a) the default
   decode (a Python loop of steps), (b) ``quantize="bf16_pallas"`` and (c)
   ``quantize="int8_pallas"`` (the K-step decode kernel). Each pass is
   warmed up at its shapes, then run (every call draws its prenet dropout
   from the synthesizer's seed) with the launch counters zeroed just
   before and read just after. After
   (a) the mel, GE2E LSTM, BiLSTM, BiGRU and Griffin-Lim kernels must each
   have launched; after (b) and (c) the decode kernel must have launched
   and the plain decode step must not have run. The wavs must be finite
   int16, every mel length > 0, and the enrollment embedding must agree
   with the port's plain CPU path. Each pass is then repeated (same
   dropout draws) under ``torch.profiler``: its device busy time over the
   unprofiled pass's wall time gives the device's idle share, and the
   repeat must decode the same mel lengths (one request, one answer).
   Whole-utterance agreement: (a) against (b), and (c) against the port's
   plain ``quantize="int8"`` decode on the card, under one seed.
   The mel-only configuration (``Linear_Head.Use: false``, vocoding through
   the filterbank pseudo-inverse) stays driven by one short request.
   Vocoder passes: (e) the checkpoint as it is with
   ``Sound.Griffin_Lim_Momentum: 0.99`` (the staged kernel's momentum mode
   must launch); (f) the same request with ``GL_DENSE_KERNEL=1``, plain and
   with momentum (the dense kernel must launch, the staged one must not;
   the spectral convergence of the wavs within 5% of pass (a)'s, and
   better with momentum than without). Streaming (g): the mel-only
   configuration streamed with ``segment_steps=16`` under the default
   decode and ``int8_pallas``: the staged kernel vocodes every window at
   T = 47, the decode kernel runs the int8 segments, the chunks are finite
   int16 and the streamed mel equals ``synthesize``'s under one seed.
   Train phase: teacher-forced steps at full width (see its comments);
   after the timed steps one extra forward records the attention step's
   inputs at frame 32. Attention-step probe (h): the port's
   ``tools/attention_probe.py`` at its defaults (B 96, S 100, 200 dependent
   steps, seeded random weights) and at the train phase's recorded frame
   with the checkpoint's attention weights: the kernel loop must launch
   ``csrc/attention_step.cu`` once a step and run no plain step, the plain
   loop no kernel; the looped outputs of the two agree within 1e-3 of the
   peak; both loops are timed (two-point slope, CUDA events) and profiled.
   The serving daemon (i): ``serve.TTSServer`` over the checkpoint as it is
   under ``bf16_pallas`` on 127.0.0.1 (max_batch 8, a 250 ms window):
   /enroll, /speakers, 8 concurrent /synthesize (the four texts twice), one
   ``Accept: audio/wav``, the malformed payloads of ``_parse_request`` (each
   its 400 with the port's message), /stream on this checkpoint (501) and
   /stream through a second server over the mel-only configuration (>= 2
   chunks, the PCM of ``Synthesizer.stream``). The served bytes must be the
   rows the worker's own ``synthesize`` returned, each batch re-run
   directly must decode the same lengths with mels within 1e-4, /stats must
   show a batch of 2 or more rows, and the six forward kernels must launch
   with no plain version running; prints the burst's wall time, requests a
   second and /stats p50 / p95 latency beside the card's name and power
   limit. Then a burst of 24 concurrent /synthesize through a server with
   the default ``max_batch`` (32): every reply 200, /stats showing a batch
   of more than 16 requests (padded to 32 rows: two row groups of the
   decode kernel, one launch each a chunk), that batch re-run directly
   within 1e-4.
   The train phase runs the decoder scan through its autograd Function
   (the hand-written backward), times the same step with the scan under
   autograd (``decoder_tf_scan_ref``) and counts both steps' device
   operations, and holds one call's gradients against the autograd loop's
   (f32 1e-3, bf16 5e-2 of each gradient's peak).
   Training end to end (j): ``python -m multi_speaker_tts_tpu_torch.train``
   through ``main(argv)`` at the production widths on a synthetic corpus
   (``-mode ge2e`` 5 steps; ``-mode tts -ge2e_checkpoint`` 6 steps saving
   at step 3; a resume to step 8; ``export_compact`` and
   ``Synthesizer.from_compact`` of the export synthesizing one text): every
   loss finite, every step launching its mode's kernels with no plain
   backward, the resume starting at the saved step with bit-equal params,
   the export equal to the trained arrays at f16, the wav int16.
   Data parallelism, sharding and evaluation (k): (k1) two spawned ranks
   (NCCL with a card a rank when there are two cards, else both on
   ``cuda:0`` over an explicitly named gloo; the line says which) train the
   checkpoint as it is (GE2E trainable, dropout on) on their halves of the
   8-row train batch, three steps, held against the single-process step on
   the same rows on the card (losses, gradient norm, every parameter after
   step 1), the ranks bit-equal after three steps, each step launching the
   six train kernels with no plain backward, the ranks joined on their exit
   codes; (k2) the four texts under ``bf16_pallas`` sharded over a mesh of
   two entries against the unsharded call (equal lengths, mel and linear
   within 5e-2, the decode kernel launched in each shard); (k3) ``python -m
   multi_speaker_tts_tpu_torch.evaluate -sv`` through ``main(argv)`` on
   (j)'s export and corpus, on the card against ``-device cpu`` (finite
   metrics, kernel #2 launched by ``speaker_verification``, losses, EER and
   cosines within the stated tolerances).
   A reference torch checkpoint (l): the port's reference torch model at
   the checkpoint's own hp, filled from its arrays by the inverse mapping
   (:func:`reference_models_from_tree`), saved reference-style, converted
   (``convert_full_checkpoint``, ``export_compact``) and served
   (``Synthesizer.from_compact``): params bit-equal; the four texts under
   the default decode and ``bf16_pallas`` bit-equal to the checkpoint's own
   (lengths, mel, linear, wav) with #1-#6 launched; ``python -m
   multi_speaker_tts_tpu_torch.convert`` as a subprocess writing the same
   params; the reference model's teacher-forced forward on the card against
   the port's ``Tacotron`` in f32 within 1e-3 of each output's peak. The
   same checkpoint as f32 (m): enrollment and fixed-length synthesis by the
   reference's routing (the recurrences on the plain route, their three
   dispatch lines printed; #1 and #4 launched, #2, #3 and #5 not) against
   the port's CPU f32 synthesis under the same prenet masks (mel 1e-3), one
   train step at B 8 against the CPU's (losses 1e-4, gradient norm 1e-3)
   with no recurrence kernel launched, and each recurrence wrapper raising
   on a direct f32 call. The tools (n): ``tools/stream_quality.py`` on
   ``demo/serving_ckpt.msgpack`` and ``tools/profile_train.py`` on the
   train step at (j)'s shapes, and the five probe tools: ``ge2e_roofline``
   at 16 x 10 x 160, ``decode_probe -steps 128``, ``gates_probe``,
   ``decode_kernel_ab`` at S 48 and 1024 (the decode kernel launched in its
   variants) and ``sv_harmonic_control`` on (j)'s export and corpus. Long
   texts (o): 16 texts whose longest is 206 characters (S 208), a text of
   S 1008, one at each kernel mode's one-row limit and one past the bf16
   limit, under the default decode, ``bf16_pallas`` and ``int8_pallas``: no
   call raises, the decode kernel launches once a row group a chunk (as
   many rows a launch as fit its shared memory at S), past the limit the
   plain loop runs with one ``[dispatch] decode -> plain`` line and no
   launch, the same request twice decodes the same lengths; then a burst
   of the 16 texts to a ``bf16_pallas`` daemon, every reply 200.
   Every batch and width the reference's gates admit (p): (p1) one
   ``GE2ETrainer`` step at GE2E's published batch, 64 speakers x 10
   utterances of 160-frame crops from seeded speech-like clips, at the
   repo's GE2E widths (768 x 3): a finite loss, the LSTM backward launched
   in its row groups (3 layers x 2), and the step's gradients again with
   the plain reverse pass in place of the kernel (loss, gradient norm
   within 2e-2, dG of the first 8 rows of every layer within 1e-2 of the
   peak); (p2) a fresh ``Trainer`` at decoder LSTM 1536, attention 640 and
   CBHG ``GRU_Size`` 512 (256 a direction), its weights set to a trained
   model's scale N(0, 0.02), through ``Synthesizer.from_state``: enroll ->
   synthesize (fixed length, 64 steps: at random weights the stop logit
   fires at once) -> Griffin-Lim under ``bf16_pallas`` and ``int8_pallas``
   (mel, GE2E LSTM, BiLSTM, the wide BiGRU, the decode kernel past H 1024
   and the staged Griffin-Lim launched; no plain decode step and no
   ``[dispatch] ... -> plain`` line; a repeat decodes the same lengths),
   then one train step of 8 rows (the wide BiGRU's residual mode and
   backward launched); (p3) ``dsp.melspectrogram_auto`` at n_fft 32, 128,
   8192, 16384, 32768 (the FFT route's global-memory mode), 6000 and 17000
   (the DFT route and its global-memory mode), each route's launches
   counted. The LSTM family at every width the JAX gate admits, and the
   reference's routes (q): (q1) one ``GE2ETrainer`` step at a GE2E LSTM of
   1792 x 3, 16 speakers x 10 utterances of 160-frame crops: #2r and #8 on
   their wide layouts, launched once a row group (5 forward groups a layer,
   one backward), and the step's gradients again with the plain reverse
   pass (p1's gates); (q2) a fresh ``Trainer`` with an encoder BiLSTM of
   2304 (1152 a direction) and a GE2E LSTM of 1792 at N(0, 0.02) through
   ``Synthesizer.from_state``: enroll -> synthesize (fixed length) ->
   Griffin-Lim, then one train step of 8 rows (#2, #2r, #3, #3r, #8, #9 on
   their wide routes, no ``[dispatch] ... -> plain`` line); (q3) the routed
   cases: Griffin-Lim at n_fft 1024 / T 1300 and 4096 / 512 / T 400 (GEMM,
   as the JAX package), a bf16 decode at H 2176 and a BiGRU of 1260 a
   direction (the plain versions), each with its ``[dispatch]`` line and no
   launch of the refused kernel. The last shapes the reference's gates
   launch, and data parallelism across hosts (r): (r1) a fresh ``Trainer``
   with a decoder LSTM of 3072 x 2 at N(0, 0.02) through
   ``Synthesizer.from_state`` under ``int8_pallas``: enroll and 32
   fixed-length decoder steps (64 frames), twice (#6 in passes of four m-tiles, launched on
   every chunk, no plain decode step, no ``[dispatch]`` line, every chunk
   and the output bit-equal); (r2) a fresh ``Trainer`` with a CBHG BiGRU of
   1280 a direction: a synthesis under ``bf16_pallas`` and a train step of
   8 rows (#5, #5r, #10 on the wide route's streamed build, no plain
   route), the step's gradients again with the plain reverse pass (p1's
   gates); (r3) ``griffin_lim_auto`` at 4096 / 512 / T 304 and 16384 /
   2048 / T 79, one row, 8 iterations (the dense kernel once a chunk, its
   dense ``[dispatch]`` line, no GEMM line); (r4) two spawned ranks each
   presenting a host of its own (``LOCAL_RANK`` 0, ``LOCAL_WORLD_SIZE`` 1,
   gloo on the one card): step 1's losses within 1e-4 of (k1)'s ranks' and
   its gradient norm within (k1)'s 2e-2 (two processes of one step may take
   other kernel choices on the card: bit-equal in two runs, 4e-7 and 3.5e-4
   apart in a third). The HiFi-GAN vocoder (s): the checkpoint with
   ``Vocoder.Type: HiFiGAN`` (V1, seeded weights, bf16) synthesizes the
   four texts with the launch counts zeroed just before: each generator
   call launches the MRF kernel 72 times and its pointwise kernel 13 times,
   counts 36 ``vocode.mrf_kernel_steps`` a row, prints no ``[dispatch]
   hifigan_mrf`` line; then the generator on a seeded 32 x 400-frame mel
   (the ``synth_hifigan.b32-short`` cell's largest bucket), ``mrf_in`` and
   the activation pass bit-equal to their plain forms at each stage, whose
   MRF inputs row #12 reads.
3. Kernel phase: each kernel's wrapper is called again on the exact
   inputs the main path gave it (recorded during step 2), held against its
   plain PyTorch version on the card with a stated tolerance, and timed
   with CUDA events beside the plain version and, where one PyTorch call
   computes the same function, that call (timed only; the port never
   calls it). The LSTM and BiLSTM rows also carry ``floor_ms``: T rounds
   of their grid barrier alone on their grid, the least time T dependent
   steps of that design take; the staged Griffin-Lim rows its 2 n_iter + 1
   rounds on its grid; the BiGRU rows T steps of their recurrent
   product and block barrier alone on their grid; the GE2E rows also
   ``one_step_ms`` (the kernel on one step) and ``floor_one_round_ms``,
   which split a step's cost from the launch's. The mel row's bound is the
   least work of the function (an FFT a frame, the basis's nonzeros), with
   the DFT matmul's beside it (``dft_bound_ms``), and ``fft_route_ms``
   times the port's FFT route (``dsp.melspectrogram``: ``torch.stft``,
   several calls) on the same clip, a real-FFT yardstick that no path of
   the port calls on the card. The mel kernel's DFT route (an n_fft that
   is not a power of two) gets a row at 800 / 200 and one at 600 / 150:
   ``dsp.melspectrogram_auto`` on the three demo wavs launches it three
   times a width (counted), each call within 1e-4 of the plain version,
   timed beside ``torch.stft`` and the basis product. The decode rows also
   hold pass (o)'s first chunks at S 208, 1008 and the mode's one-row
   limit, at 16 rows and at one, to the plain version (bf16 by the probe
   rule), and time them. Pass (p)'s rows: #8 at 640 rows (the row groups'
   launches), the wide BiGRU's three modes at (p2)'s H 256 and seeded H
   384, 512 and 1024, the decode kernel past H 1024 in both modes ((p2)'s
   first chunk cut to K 4, seeded decoders at H 1152-2048, B 1 and 16, S 64
   and 208, attention 1024), and the mel front-end's routes and modes at
   (p3)'s widths, each with its production row's tolerance. Pass (q)'s
   rows: #2 at (q2)'s enrollment (GE2E 1792) and seeded 1152 (D = H) and
   1664 (D 80), #2r and #8 at (q1)'s 160 rows, #3 / #3r at (q2)'s encoder
   and seeded 32 rows (1152 a direction), #9 at (q2)'s train step, each with
   cuDNN's ``nn.LSTM`` at the same shapes. Pass (r)'s rows: #6 int8 at
   (r1)'s first chunk cut to K 4 (H 3072) and seeded H 2176, 3072 and 4096;
   #5, #5r and #10 at (r2)'s calls (1280 a direction) and seeded H 2048 and
   4096, with cuDNN's GRU; #7 at (r3)'s 16384 / 2048 call, its 4096 / 512
   call and seeded 2304 / 1152, 8192 / 4096 and 32768 / 4096, by the dense
   rows' probe rule with the probes on the card. Row #12 (``hifigan_mrf``):
   pass (s)'s four MRFs (18 launches each) against the same launches
   through the plain convolution (max gap over the plain output's peak,
   within HIFIGAN_MRF_TOL), stage 3's timed and stages 0-2 in
   ``also_times``, each beside its bound and cuDNN's bf16 MRF of the plain
   route; ``activation_ms`` (the activation pass at stage 3's shape) and
   ``forward_ms`` (the generator at 32 x 400 frames).
4. Prints one ``{"kernels": [...]}`` line, the card's name and power limit
   from nvidia-smi, and as the last line
   ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
   the last line.

TF32 is switched off for matmuls and cuDNN (``allow_tf32 = False``), so
every f32 product of the main path and of the plain versions runs in full
f32.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
CKPT = ROOT / "demo" / "serving_ckpt_full.msgpack"
ENROLL = [ROOT / "demo" / f for f in
          ("enroll_spk0_utt0.wav", "enroll_spk0_utt1.wav", "enroll_spk5_utt0.wav")]
# The five demo wavs, cycled into the train phase's batch.
TRAIN_WAVS = ENROLL + [ROOT / "demo" / f for f in ("clone_spk0.wav", "clone_spk5.wav")]
TRAIN_BATCH, TRAIN_STEPS = 32, 5
TEXTS = [
    "hello world, this is a test of the port.",
    "the quick brown fox jumps over the lazy dog.",
    "zero shot speaker cloning on one card.",
    "griffin lim turns the mel back into sound.",
]
# Pass (o): twelve more short texts beside TEXTS, and the paragraph the long
# texts are cut from (lowercase words: a character a token, and one more).
MORE_TEXTS = [
    "she sells sea shells by the sea shore.", "a stitch in time saves nine.",
    "all that glitters is not gold.", "actions speak louder than words.",
    "the early bird catches the worm.", "practice makes perfect.", "better late than never.",
    "pack my box with five dozen liquor jugs.", "how vexingly quick daft zebras jump.",
    "the five boxing wizards jump quickly.", "sphinx of black quartz, judge my vow.",
    "a long text goes first in this batch.",
]
PARAGRAPH = ("a voice service reads whole paragraphs aloud, and it batches them with short "
             "replies from the same speaker. the quick brown fox jumps over the lazy dog, "
             "while she sells sea shells by the sea shore. all that glitters is not gold, "
             "and a stitch in time saves nine. ")
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32 CUDA-core,
# bf16 and int8 tensor-core operations/s, and the SM boost clock.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
SM_CLOCK_HZ = 1.98e9


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _time_ms(fn, warmup: int, reps: int, queue_ahead: bool = False) -> float:
    """Mean ms a call, from CUDA events around ``reps`` calls after
    ``warmup``. ``queue_ahead`` first holds the card in a 20 ms spin, so
    that the host queues every call before the card reaches the first: the
    events then time the card's work alone, also for calls shorter than
    their host-side dispatch."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if queue_ahead:
        torch.cuda._sleep(int(0.02 * SM_CLOCK_HZ))
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


class _GcPauses:
    """Python's garbage-collector pauses while active, as (generation, ms)."""

    def __enter__(self):
        self.pauses, self._start = [], 0.0
        gc.callbacks.append(self._note)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._note)

    def _note(self, phase, info):
        if phase == "start":
            self._start = time.perf_counter()
        else:
            self.pauses.append((info["generation"],
                                round((time.perf_counter() - self._start) * 1e3, 2)))


# Whether the wrappers of _record keep what they see.
_RECORDING = [True]


def _record(module, name: str, store: list, keep: int | None = None, instead=None) -> None:
    """Wrap ``module.name`` so every call's arguments and result are kept
    while _RECORDING is on. With ``keep`` (a pass's own store) the first
    ``keep`` calls are kept whatever _RECORDING says; ``instead`` runs in
    place of the original, on the same arguments."""
    original = getattr(module, name)
    run = original if instead is None else instead

    def recorded(*args, **kwargs):
        result = run(*args, **kwargs)
        if _RECORDING[0] if keep is None else len(store) < keep:
            store.append((args, kwargs, result))
        return result

    setattr(module, name, recorded)
    recorded.original = original


def _restore(module, *names: str) -> None:
    """Undo :func:`_record` for ``module.name`` of each name."""
    for name in names:
        setattr(module, name, getattr(module, name).original)


def _tensors(x) -> list:
    """The tensors of a result, nested tuples (a carry) walked in order."""
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return [x] if hasattr(x, "data_ptr") else []


@contextlib.contextmanager
def _recorded(*hooks):
    """:func:`_record` each ``(module, name, store, keep[, instead])`` for
    the block, :func:`_restore` after it."""
    for module, name, *rest in hooks:
        _record(module, name, *rest)
    try:
        yield
    finally:
        for module, name, *_ in reversed(hooks):
            _restore(module, name)


def _bound_ms(n_bytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BPS, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _profile(label: str, fn):
    """``fn()`` under torch.profiler: device busy time (the union of CUDA
    kernel and copy intervals), its share of the profiled wall time, the
    host time of the port's stage spans, and the kernels by device time. A
    first, empty profile takes the profiler's start-up cost. Returns the
    busy ms and what ``fn`` returned."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        torch.ones(1, device="cuda").sum().item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stages = ("enroll.", "synth.", "stream.")
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
    _profile.last_ops = len(intervals)
    print(f"[{label}] profile (under the profiler): wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%, {len(intervals)} device ops")
    if spans:
        print(f"[{label}] profile stage spans (host ms): "
              + json.dumps({k: round(v, 2) for k, v in sorted(spans.items())}))
    print(f"[{label}] profile top device ops (ms): "
          + json.dumps([[k[:70], round(v, 3)] for k, v in top]))
    return busy_ms, out


def _train_batch(hp, n: int, seed: int) -> dict:
    """A batch of ``n`` in the ``collate_tts`` layout at the checkpoint's own
    buckets: the five demo wavs cycled, mel and linear targets from the
    port's front-end (``dsp.melspectrogram`` / ``dsp.spectrogram``, on the
    CPU), tokens from ``TEXTS``, reference crops drawn from a seeded numpy
    generator."""
    import numpy as np
    import torch

    from multi_speaker_tts_tpu_torch.audio import dsp, wav_io
    from multi_speaker_tts_tpu_torch.data.collate import collate_tts
    from multi_speaker_tts_tpu_torch.text import encode_text

    cfg = dsp.DSPConfig.from_hp(hp)
    feats = []
    for path in TRAIN_WAVS:
        wav = torch.from_numpy(wav_io.load_wav(path, target_sr=hp.Sound.Sample_Rate)[0])
        feats.append((dsp.melspectrogram(wav, cfg).numpy(), dsp.spectrogram(wav, cfg).numpy()))
    pats = [{"Tokens": encode_text(TEXTS[i % len(TEXTS)], hp), "Mel": feats[i % 5][0],
             "Spect": feats[i % 5][1], "Speaker_ID": i % 5} for i in range(n)]
    buckets = hp.Train.Batch_Bucketing
    return collate_tts(pats, buckets.Token_Buckets[0], buckets.Mel_Buckets[0], hp.Sound.Mel_Dim,
                       int(hp.Decoder.N_Frames_Per_Step), hp.Speaker_Embedding.GE2E.Window_Length,
                       np.random.default_rng(seed), hp.Sound.Spectrogram_Dim)


def reference_models_from_tree(params: dict, batch_stats: dict, hp):
    """The port's reference torch models (``convert/reference_torch.py``)
    filled from a JAX-layout tree, by ``convert/mapping.full_mapping`` read
    backwards: Dense and Conv weights transposed back, an LSTM's one bias
    all in ``bias_ih`` with ``bias_hh`` zero, a GRU's two biases as they are,
    BatchNorm as its four tensors. -> (tacotron, ge2e), on the CPU. Every
    mapped torch key is filled; only BatchNorm's ``num_batches_tracked``
    stays as built. Converting a reference-style save of the result gives
    the tree back bit for bit (f32 transposes and ``b + 0`` are exact)."""
    import numpy as np
    import torch

    from multi_speaker_tts_tpu_torch.convert import state_dict as sd
    from multi_speaker_tts_tpu_torch.convert.mapping import full_mapping
    from multi_speaker_tts_tpu_torch.convert.reference_torch import (
        build_reference_ge2e, build_reference_tacotron,
    )

    def leaf(tree, path):
        for k in path.split("/"):
            tree = tree[k]
        return tree

    def inverse(converter, p, stats):
        if converter is sd.convert_dense:
            return [p["kernel"].T] + ([p["bias"]] if "bias" in p else [])
        if converter is sd.convert_conv1d:
            return [np.transpose(p["kernel"], (2, 1, 0))] + ([p["bias"]] if "bias" in p else [])
        if converter is sd.convert_lstm:
            return [p["w_ih"].T, p["w_hh"].T, p["b"], np.zeros_like(p["b"])]
        if converter is sd.convert_gru:
            return [p["w_ih"].T, p["w_hh"].T, p["b_ih"], p["b_hh"]]
        if converter is sd.convert_batchnorm:
            return [p["scale"], p["bias"], stats["mean"], stats["var"]]
        if converter is sd.convert_embedding:
            return [p["embedding"]]
        raise ValueError(f"no inverse for {converter.__name__}")

    state = {}
    for path, (converter, keys) in full_mapping(hp).items():
        stats = leaf(batch_stats, path) if converter is sd.convert_batchnorm else None
        values = inverse(converter, leaf(params, path), stats)
        if len(values) != len(keys):
            raise ValueError(f"{path}: {len(values)} arrays for torch keys {keys}")
        state.update({k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                      for k, v in zip(keys, values)})
    taco, ge2e = build_reference_tacotron(hp), build_reference_ge2e(hp)
    for model, prefix in ((taco, ""), (ge2e, "ge2e.")):
        own = {k[len(prefix):]: v for k, v in state.items()
               if k.startswith(prefix) and (prefix or not k.startswith("ge2e."))}
        missing, unexpected = model.load_state_dict(own, strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise ValueError(f"{prefix or 'tacotron'}: missing {missing[:5]}, "
                             f"unexpected {unexpected[:5]}")
    return taco.eval(), ge2e.eval()


def train_end_to_end(kernels: dict, per_step: dict, plain_bwd: dict,
                     work: pathlib.Path) -> list[str]:
    """Pass (j): ``python -m multi_speaker_tts_tpu_torch.train`` driven
    in-process (``main(argv)``) at the production widths of the shipped
    defaults on a ``generate_synthetic_dataset`` corpus of 16 speakers x 2
    utterances ("rich" voices): one GE2E batch (16 x 10 crops of 32
    frames) and one TTS batch (32). ``-mode ge2e`` for 5 steps, ``-mode tts
    -ge2e_checkpoint`` for 6 steps saving at step 3 (and 6), a resume to
    step 8, then ``export_compact`` of the last checkpoint and
    ``Synthesizer.from_compact`` of the export synthesizing one text. Every
    step's launches are read around its ``train_step``. The corpus and the
    export stay in ``work`` (``corpus/patterns``, ``export.msgpack``) for
    pass (k3). Returns the failures."""
    import numpy as np
    import torch

    from multi_speaker_tts_tpu_torch.checkpoints import load_compact
    from multi_speaker_tts_tpu_torch.data.pattern_generator import generate_synthetic_dataset
    from multi_speaker_tts_tpu_torch.hparams import default_hparams
    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.train import __main__ as train_cli
    from multi_speaker_tts_tpu_torch.train.checkpoints import CheckpointManager, export_compact
    from multi_speaker_tts_tpu_torch.train.ge2e_trainer import GE2ETrainer
    from multi_speaker_tts_tpu_torch.train.trainer import Trainer
    from multi_speaker_tts_tpu_torch.weights import params_to_jax

    fails = []
    steps = {"ge2e": [], "tts": []}  # (step, ms, launches, metrics) per train_step
    resumed = {}

    def watch(cls, mode):
        original = cls.train_step

        def step(self, batch):
            if mode == "tts" and "run" in resumed and "at" not in resumed:
                saved, at = CheckpointManager(self.checkpoints.directory).restore()
                resumed["at"], resumed["step"] = at, self.step
                resumed["equal"] = all(torch.equal(saved["params"][n], p.detach().cpu())
                                       for n, p in zip(self.param_names, self.params))
            counts = {name: k.launches for name, k in kernels.items()}
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            m = original(self, batch)
            stop.record()
            torch.cuda.synchronize()
            steps[mode].append((self.step, start.elapsed_time(stop),
                                {n: kernels[n].launches - counts[n] for n in kernels}, m))
            return m

        cls.train_step = step
        return original

    originals = {GE2ETrainer: watch(GE2ETrainer, "ge2e"), Trainer: watch(Trainer, "tts")}
    for store in plain_bwd.values():
        store.clear()
    # GE2E crops of 32 frames: the corpus's utterances are 35-103 frames, and
    # the default 160-frame crops would end in zero padding, which every
    # utterance embeds alike (a constant loss of ln 16).
    hp = default_hparams(Train={"Checkpoint_Save_Interval": 3, "Logging_Interval": 1},
                         GE2E_Train={"Frame_Length": 32})
    # The launches of a GE2E step: a forward launch a row group of each
    # layer (up to 32 rows a group), a backward launch a layer (one group).
    from multi_speaker_tts_tpu_torch.ops import _build, lstm_kernel

    rows_g, card = hp.GE2E_Train.Batch_Speakers * hp.GE2E_Train.Batch_Utterances, \
        _build.card_limits("cuda")
    H_g, n_g = hp.Speaker_Embedding.GE2E.LSTM.Sizes, hp.Speaker_Embedding.GE2E.LSTM.Stacks
    ge2e_step = {
        "ge2e_lstm_layer_residuals": sum(
            len(lstm_kernel.fwd_row_groups(1, D, H_g, rows_g, card))
            for D in [hp.Sound.Mel_Dim] + [H_g] * (n_g - 1)),
        "ge2e_lstm_bwd": n_g * len(lstm_kernel.bwd_row_groups(1, H_g, rows_g, card))}
    peak = {}
    try:
        t0 = time.perf_counter()
        meta = generate_synthetic_dataset(hp, work / "corpus", n_speakers=16,
                                          n_utterances=2, voice="rich")
        pats = str(work / "corpus" / "patterns")
        print(f"[j train] corpus: {len(meta['Files'])} patterns, mel lengths "
              f"{int(meta['Mel_Lengths'].min())}-{int(meta['Mel_Lengths'].max())}, tokens "
              f"{int(meta['Token_Lengths'].min())}-{int(meta['Token_Lengths'].max())} "
              f"({time.perf_counter() - t0:.1f} s)")
        hp_file = work / "hp.json"
        hp_file.write_text(json.dumps(hp.to_dict()))
        common = ["-hp", str(hp_file), "-train_pattern", pats, "-log", str(work / "logs")]
        runs = (("ge2e", ["-mode", "ge2e", "-checkpoint", str(work / "ge2e"), "-max_step", "5"]),
                ("tts", ["-mode", "tts", "-checkpoint", str(work / "tts"), "-ge2e_checkpoint",
                         str(work / "ge2e"), "-max_step", "6"]),
                ("resume", ["-mode", "tts", "-checkpoint", str(work / "tts"),
                            "-max_step", "8"]))
        for name, argv in runs:
            if name == "resume":
                resumed["run"] = True
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            train_cli.main(common + argv)
            torch.cuda.synchronize()
            peak[name] = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"[j train] {name}: main() returned after "
                  f"{time.perf_counter() - t0:.1f} s, peak device memory {peak[name]:.2f} GiB")
        tts_steps = CheckpointManager(work / "tts").steps()
        state, last = CheckpointManager(work / "tts").restore()
        hp_t = hp.replace(Speaker_Embedding={"GE2E": {
            "Pretrained_Checkpoint": str(work / "ge2e")}})
        params, batch_stats = params_to_jax({**state["params"], **state["batch_stats"]}, hp_t)
        export = work / "export.msgpack"
        export_compact(export, params, batch_stats, {"hp": hp_t.to_dict()})
        got_p, got_bs, _ = load_compact(export)
        flat = {**state["params"], **state["batch_stats"]}
        want_p, want_bs = params_to_jax(
            {k: v.half().float() for k, v in flat.items()}, hp_t)
        export_equal = all(np.array_equal(a, b) for a, b in
                           zip(_leaves(got_p) + _leaves(got_bs),
                               _leaves(want_p) + _leaves(want_bs)))
        synth = Synthesizer.from_compact(str(export), seed=0)
        out = synth.synthesize([TEXTS[0]], synth.enroll(str(ENROLL[0])), max_steps=64,
                               pcm16=True)[0]
        wav = out["wav"]
        print(f"[j train] tts checkpoints at steps {tts_steps}; export of step {last}: "
              f"{export.stat().st_size / 2 ** 20:.1f} MB, arrays equal to the trained ones "
              f"at f16: {export_equal}; from_compact synthesized {wav.dtype} {wav.shape}, "
              f"mel_length {out['mel_length']} (max_steps 64)")
    finally:
        for cls, original in originals.items():
            cls.train_step = original
    for mode, want in (("ge2e", ge2e_step), ("tts", per_step)):
        ms = [x[1] for x in steps[mode][1:]] or [steps[mode][0][1]]
        print(f"[j train] -mode {mode}: steps {[x[0] for x in steps[mode]]}, ms a step (CUDA "
              f"events, after the first) {statistics.mean(ms):.2f} (all "
              f"{json.dumps([round(x[1], 2) for x in steps[mode]])}); losses "
              f"{json.dumps([round(x[3].get('loss', x[3].get('total', 0.0)), 5) for x in steps[mode]])}"
              f"; peak memory {max(peak.get(mode, 0), peak.get('resume', 0) if mode == 'tts' else 0):.2f}"
              f" GiB ({_smi()})")
        for step, _, launches, m in steps[mode]:
            if not all(math.isfinite(v) for v in m.values()) or m.get("skipped_nonfinite"):
                fails.append(f"[j train] {mode} step {step}: metrics {m}")
            if {n: launches[n] for n in want} != want:
                fails.append(f"[j train] {mode} step {step}: launches "
                             f"{ {n: launches[n] for n in want} }, want {want}")
    if [x[0] for x in steps["ge2e"]] != [1, 2, 3, 4, 5] or \
            [x[0] for x in steps["tts"]] != [1, 2, 3, 4, 5, 6, 7, 8]:
        fails.append(f"[j train] steps run: {[x[0] for x in steps['ge2e']]}, "
                     f"{[x[0] for x in steps['tts']]}")
    if any(plain_bwd.values()):
        fails.append(f"[j train] a plain backward ran on the card: "
                     f"{ {k: len(v) for k, v in plain_bwd.items()} }")
    print(f"[j train] resume: started at step {resumed.get('step')} from checkpoint step "
          f"{resumed.get('at')}, params bit-equal to the saved ones: {resumed.get('equal')}")
    if resumed.get("at") != 6 or resumed.get("step") != 6 or not resumed.get("equal"):
        fails.append(f"[j train] resume: {resumed}")
    if 3 not in tts_steps or not export_equal:
        fails.append(f"[j train] checkpoints {tts_steps}, export equal {export_equal}")
    if wav.dtype != np.int16 or wav.size == 0 or out["mel_length"] <= 0:
        fails.append(f"[j train] synthesized {wav.dtype} {wav.shape}, {out['mel_length']}")
    return fails


def _leaves(tree: dict, prefix: str = "") -> list:
    """The arrays of a nested dict, in sorted key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [v]
    return out


# -- Pass (k): data parallelism, sharded synthesis, evaluation ---------------

DP_WORLD, DP_ROWS, DP_STEPS = 2, 8, 3
DP_TIMEOUT_S = 300
# The per-step launches of the train step (GE2E trainable), on each rank.
DP_PER_STEP = {"ge2e_lstm_layer_residuals": 3, "ge2e_lstm_bwd": 3,
               "text_encoder_bilstm_residuals": 1, "text_encoder_bilstm_bwd": 1,
               "cbhg_bigru_residuals": 1, "cbhg_bigru_bwd": 1}
# (k1) The data-parallel step differs from the single-process step by its
# summation orders only (BatchNorm sums in two halves added over the ranks,
# 4-row against 8-row products, the gradients summed over the ranks), which
# at bf16 flip roundings: the card-against-CPU whole step (same rows) is
# held to 1e-2 a loss and 2e-2 on the gradient norm, and so is this one;
# every parameter after step 1 within 5e-2 of the largest update of the
# step (an update W times too large, or a rank's share of the gradient
# lost, misses that by far).
DP_LOSS_TOL, DP_NORM_TOL, DP_PARAM_TOL = 1e-2, 2e-2, 5e-2
# (k2) Rows decode under the same prenet draws whatever the sharding; the
# sharded and the unsharded call differ in the batch sizes their products
# see. Mel and linear within 5e-2 (normalized units, peak ~4) of each other.
SHARD_TOL = 5e-2
# (k3) Card against the port's plain path on the CPU, same export, corpus and
# prenet draws: the teacher-forced losses within 2e-2 (bf16 kernels against
# their plain versions through a whole forward), the utterance embeddings
# (unit norm) within 1e-2 and the mean cosines within 2e-2, and the EER
# within 1 / 16: pass (j)'s corpus has 16 same-speaker trials, so one of
# them crossing the threshold moves the EER by up to that.
EVAL_LOSS_TOL, EMB_TOL, EER_TOL, COS_TOL = 2e-2, 1e-2, 1 / 16, 2e-2
# (k3) embeds with windows of pass (j)'s GE2E crops (32 frames, shift 16):
# the corpus's utterances are 35-103 frames, and a 160-frame window is
# mostly zero padding, through which the encoder reaches one state for
# every utterance (all cosines 1.0 on an H100, the EER ranking rounding
# noise).
EVAL_WINDOW, EVAL_SHIFT = 32, 16


def _digest(tensors) -> str:
    """sha256 of tensors' bytes, in order (bit-equality across processes)."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _dp_rank(rank: int, world: int, init: str, backend: str, out: str,
             steps: int = DP_STEPS) -> None:
    """One rank of (k1), in a spawned process: the checkpoint as it is with
    GE2E trainable, this rank's rows of the 8-row batch, the state synced
    from rank 0 (a broadcast), ``steps`` steps, launches and plain backward
    calls counted a step; rank 0 saves the params after step 1. Its card is
    its local rank's (``LOCAL_RANK`` where set: pass (r4) presents two
    hosts). Exits non-zero on any error (the parent joins on exit codes)."""
    sys.path.insert(0, str(ROOT))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from multi_speaker_tts_tpu_torch.checkpoints import load_compact
    from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel, lstm_kernel
    from multi_speaker_tts_tpu_torch.parallel import multihost
    from multi_speaker_tts_tpu_torch.train.trainer import Trainer

    device = multihost.initialize_distributed(init, world, rank, backend=backend, device="cuda")
    kernels = {"ge2e_lstm_layer_residuals": lstm_kernel.RES_KERNEL,
               "ge2e_lstm_bwd": lstm_kernel.BWD_KERNEL,
               "text_encoder_bilstm_residuals": birnn_kernel.RES_KERNEL,
               "text_encoder_bilstm_bwd": birnn_kernel.BWD_KERNEL,
               "cbhg_bigru_residuals": birnn_kernel.GRU_RES_KERNEL,
               "cbhg_bigru_bwd": birnn_kernel.GRU_BWD_KERNEL}
    plain = {name: [] for name in ("lstm_seq_layer_bwd_plain", "bilstm_bwd_plain",
                                   "bigru_bwd_plain")}
    _record(lstm_kernel, "lstm_seq_layer_bwd_plain", plain["lstm_seq_layer_bwd_plain"])
    _record(birnn_kernel, "bilstm_bwd_plain", plain["bilstm_bwd_plain"])
    _record(birnn_kernel, "bigru_bwd_plain", plain["bigru_bwd_plain"])
    params, batch_stats, meta = load_compact(CKPT)
    hp = Recursive_Parse(meta["hp"]).replace(Speaker_Embedding={"GE2E": {"Freeze": False}},
                                             Train={"Batch_Size": DP_ROWS})
    batch = _train_batch(hp, DP_ROWS, seed=0)
    rows = multihost.local_rows(DP_ROWS)
    local = {k: v[rows] for k, v in batch.items()}
    trainer = Trainer.from_params(hp, params, batch_stats, device=device, seed=0)
    trainer.sync_state()
    res = {"rank": rank, "world": multihost.process_count(), "backend": backend,
           "device": str(device), "local": multihost.local_rank(), "steps": []}
    for i in range(steps):
        counts = {n: k.launches for n, k in kernels.items()}
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = trainer.train_step(local)
        stop.record()
        torch.cuda.synchronize()
        res["steps"].append({"metrics": m, "ms": start.elapsed_time(stop),
                             "launches": {n: k.launches - counts[n] for n, k in kernels.items()}})
        if i == 0 and rank == 0:
            torch.save({n: p.detach().cpu() for n, p in zip(trainer.param_names, trainer.params)},
                       f"{out}/params1.pt")
    res["plain_bwd"] = {k: len(v) for k, v in plain.items()}
    res["digest"] = _digest([*trainer.params, *trainer.tacotron.buffers()])
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(res, f)
    multihost.barrier("done")
    multihost.shutdown()


# (k1)'s step-1 metrics on each rank, for pass (r4).
K1_STEP1: dict = {}


def _spawn_ranks(world: int, backend: str, out: str, steps: int, env=None) -> list:
    """Start ``world`` processes of :func:`_dp_rank` (``env``: variables set
    for the spawn), join them on their exit codes within DP_TIMEOUT_S."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        procs = [ctx.Process(target=_dp_rank, args=(r, world, f"file://{out}/rendezvous",
                                                    backend, out, steps))
                 for r in range(world)]
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    deadline = time.time() + DP_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.time(), 1))
    codes = []
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
        codes.append(p.exitcode)
    return codes


def dp_train(params, batch_stats, hp) -> list[str]:
    """(k1): two ranks (spawned processes) of data-parallel training against
    the single-process step on the same 8 rows on the card."""
    import tempfile

    import torch

    from multi_speaker_tts_tpu_torch.train.trainer import Trainer

    fails = []
    two_cards = torch.cuda.device_count() >= DP_WORLD
    backend = "nccl" if two_cards else "gloo"
    hp8 = hp.replace(Speaker_Embedding={"GE2E": {"Freeze": False}}, Train={"Batch_Size": DP_ROWS})
    batch = _train_batch(hp8, DP_ROWS, seed=0)
    ref = Trainer.from_params(hp8, params, batch_stats, seed=0)
    theta0 = {n: p.detach().cpu().clone() for n, p in zip(ref.param_names, ref.params)}
    m_ref = ref.train_step(batch)
    theta1 = {n: p.detach().cpu().clone() for n, p in zip(ref.param_names, ref.params)}
    del ref
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        codes = _spawn_ranks(DP_WORLD, backend, out, DP_STEPS)
        wall = time.perf_counter() - t0
        if codes != [0] * DP_WORLD:
            return [f"[k1 data-parallel] rank exit codes {codes} (backend {backend})"]
        ranks = [json.loads(pathlib.Path(f"{out}/rank{r}.json").read_text())
                 for r in range(DP_WORLD)]
        dp1 = torch.load(f"{out}/params1.pt")
    print(f"[k1 data-parallel] backend {backend} ({'one card a rank' if two_cards else 'both ranks on cuda:0'}), "
          f"{DP_WORLD} ranks x {DP_ROWS // DP_WORLD} rows, devices {[r['device'] for r in ranks]}; "
          f"spawn to join {wall:.1f} s")
    m0 = ranks[0]["steps"][0]["metrics"]
    K1_STEP1.update(backend=backend, metrics=[r["steps"][0]["metrics"] for r in ranks])
    loss_err = {k: abs(m0[k] - m_ref[k]) / max(abs(m_ref[k]), 1e-12)
                for k in m_ref if k not in ("skipped_nonfinite", "grad_norm")}
    norm_err = abs(m0["grad_norm"] - m_ref["grad_norm"]) / max(abs(m_ref["grad_norm"]), 1e-12)
    upd = max(float((theta1[n] - theta0[n]).abs().max()) for n in theta0)
    per = {n: float((dp1[n] - theta1[n]).abs().max()) / upd for n in theta1}
    worst = sorted(per.items(), key=lambda kv: -kv[1])[:3]
    print(f"[k1 data-parallel] step 1 against the single-process step on the same {DP_ROWS} rows "
          f"(card): total {m0['total']:.6f} vs {m_ref['total']:.6f}, grad_norm "
          f"{m0['grad_norm']:.4f} vs {m_ref['grad_norm']:.4f}; relative loss errors "
          + json.dumps({k: float(f"{v:.2e}") for k, v in loss_err.items()})
          + f" (tolerance {DP_LOSS_TOL}), grad_norm {norm_err:.2e} (tolerance {DP_NORM_TOL}); "
          f"params after step 1: largest |dp - single| {max(per.values()) * upd:.3e} = "
          f"{max(per.values()):.2e} of the largest update {upd:.3e} (tolerance {DP_PARAM_TOL}); "
          f"worst {json.dumps([[n, float(f'{v:.2e}')] for n, v in worst])}")
    if max(loss_err.values()) > DP_LOSS_TOL or norm_err > DP_NORM_TOL:
        fails.append(f"[k1 data-parallel] step 1: {m0} vs single {m_ref}")
    if max(per.values()) > DP_PARAM_TOL:
        fails.append(f"[k1 data-parallel] params after step 1: {worst}")
    for r in ranks:
        for i, s in enumerate(r["steps"]):
            m = s["metrics"]
            if m["skipped_nonfinite"] or not all(math.isfinite(v) for v in m.values()):
                fails.append(f"[k1 data-parallel] rank {r['rank']} step {i + 1}: {m}")
            if s["launches"] != DP_PER_STEP:
                fails.append(f"[k1 data-parallel] rank {r['rank']} step {i + 1}: launches "
                             f"{s['launches']}, want {DP_PER_STEP}")
        if any(r["plain_bwd"].values()):
            fails.append(f"[k1 data-parallel] rank {r['rank']}: plain backward {r['plain_bwd']}")
        if r["world"] != DP_WORLD:
            fails.append(f"[k1 data-parallel] rank {r['rank']} saw a world of {r['world']}")
    equal = len({r["digest"] for r in ranks}) == 1
    same_metrics = all([s["metrics"] for s in r["steps"]] == [s["metrics"] for s in ranks[0]["steps"]]
                       for r in ranks)
    print(f"[k1 data-parallel] after {DP_STEPS} steps: params and BatchNorm statistics bit-equal "
          f"on every rank: {equal}; equal metrics on every rank: {same_metrics}; totals "
          f"{json.dumps([round(s['metrics']['total'], 6) for s in ranks[0]['steps']])}; launches a "
          f"step on each rank {ranks[0]['steps'][0]['launches']}; plain backward calls "
          f"{[r['plain_bwd'] for r in ranks]}")
    ms = [[round(s["ms"], 2) for s in r["steps"]] for r in ranks]
    print(f"[k1 data-parallel] ms a step (CUDA events, each rank; "
          f"{'one card a rank' if two_cards else 'two ranks time-sharing one card over gloo: not a scaling figure'}): "
          f"{json.dumps(ms)} ({_smi()})")
    if not equal or not same_metrics:
        fails.append(f"[k1 data-parallel] ranks differ after {DP_STEPS} steps")
    return fails


def sharded_synthesis(params, batch_stats, hp, wavs, kernels) -> list[str]:
    """(k2): a mesh of two entries (two cards, or cuda:0 twice), the four
    texts under bf16_pallas, sharded against unsharded."""
    import numpy as np
    import torch

    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.models.tacotron import Tacotron
    from multi_speaker_tts_tpu_torch.ops import decoder_scan

    fails = []
    n_cards = torch.cuda.device_count()
    mesh = [torch.device("cuda", i % n_cards) for i in range(2)]
    synth = Synthesizer(hp, params, batch_stats, seed=0, quantize="bf16_pallas", mesh=mesh)
    emb = synth.enroll(wavs)
    synth.synthesize(TEXTS, emb, pcm16=True, sharded=True)  # warm-up
    whole = synth.synthesize(TEXTS, emb, pcm16=True)
    calls, plain = [], []
    infer = Tacotron.infer
    kernel = kernels["decode_segment_bf16"]

    def counted(self, tokens, *args, **kwargs):
        before = kernel.launches
        out = infer(self, tokens, *args, **kwargs)
        calls.append((str(tokens.device), tokens.shape[0], kernel.launches - before))
        return out

    _record(decoder_scan, "decoder_cell_step", plain)
    Tacotron.infer = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded = synth.synthesize(TEXTS, emb, pcm16=True, sharded=True)
        torch.cuda.synchronize()
        t_sharded = time.perf_counter() - t0
    finally:
        Tacotron.infer = infer
        _restore(decoder_scan, "decoder_cell_step")
    lengths = ([x["mel_length"] for x in whole], [x["mel_length"] for x in sharded])
    mel_err = max(float(np.abs(a["mel"] - b["mel"]).max()) for a, b in zip(whole, sharded)
                  if a["mel_length"] == b["mel_length"]) if lengths[0] == lengths[1] else None
    lin_err = max(float(np.abs(a["linear"] - b["linear"]).max()) for a, b in zip(whole, sharded)
                  if a["mel_length"] == b["mel_length"]) if lengths[0] == lengths[1] else None
    print(f"[k2 sharded] mesh {[str(d) for d in mesh]}, bf16_pallas: shards (device, rows, decode "
          f"launches) {calls}; mel_lengths unsharded {lengths[0]}, sharded {lengths[1]}; max |mel "
          f"diff| {mel_err}, max |linear diff| {lin_err} (tolerance {SHARD_TOL}); sharded call "
          f"{t_sharded * 1e3:.1f} ms (shards one after another) ({_smi()})")
    if lengths[0] != lengths[1] or mel_err > SHARD_TOL or lin_err > SHARD_TOL:
        fails.append(f"[k2 sharded] lengths {lengths}, mel {mel_err}, linear {lin_err}")
    if len(calls) != 2 or any(c[2] == 0 or c[1] != 2 for c in calls) or \
            [c[0] for c in calls] != [str(d) for d in mesh]:
        fails.append(f"[k2 sharded] shards {calls}")
    if plain:
        fails.append(f"[k2 sharded] {len(plain)} plain decode steps under bf16_pallas")
    for x in sharded:
        if x["wav"].dtype != np.int16 or x["wav"].size == 0:
            fails.append(f"[k2 sharded] wav {x['wav'].dtype} {x['wav'].shape}")
    return fails


def evaluate_pass(export: pathlib.Path, patterns: str, kernels) -> list[str]:
    """(k3): ``python -m multi_speaker_tts_tpu_torch.evaluate -sv`` through
    ``main(argv)`` on pass (j)'s export and corpus (its hparams with GE2E
    windows of (j)'s crops, ``-hp``), on the card and with ``-device cpu``
    (the port's plain path)."""
    import numpy as np

    from multi_speaker_tts_tpu_torch import evaluate
    from multi_speaker_tts_tpu_torch.checkpoints import load_compact
    from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse

    fails = []
    sv_launches, embeddings = [], []
    sv = evaluate.speaker_verification

    def counted(*args, **kwargs):
        before = kernels["ge2e_lstm_layer"].launches
        out = sv(*args, **kwargs, return_embeddings=True)
        sv_launches.append(kernels["ge2e_lstm_layer"].launches - before)
        embeddings.append(out.pop("embeddings"))
        out.pop("speaker_of")
        return out

    hp_file = export.parent / "evaluate_hp.json"
    hp_file.write_text(json.dumps(Recursive_Parse(load_compact(export)[2]["hp"]).replace(
        Speaker_Embedding={"GE2E": {"Window_Length": EVAL_WINDOW,
                                    "Window_Shift": EVAL_SHIFT}}).to_dict()))
    argv = ["-checkpoint", str(export), "-pattern", patterns, "-batches", "2", "-sv",
            "-hp", str(hp_file)]
    evaluate.speaker_verification = counted
    try:
        before = {n: k.launches for n, k in kernels.items()}
        t0 = time.perf_counter()
        card = evaluate.main(argv)
        t_card = time.perf_counter() - t0
        launched = {n: k.launches - before[n] for n, k in kernels.items()
                    if k.launches != before[n]}
        t0 = time.perf_counter()
        cpu = evaluate.main(argv + ["-device", "cpu"])
        t_cpu = time.perf_counter() - t0
    finally:
        evaluate.speaker_verification = sv
    errs = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12)
            for k in ("mel_pre", "mel_post", "linear", "stop", "total")}
    emb_err = float(np.abs(embeddings[0] - embeddings[1]).max())
    print(f"[k3 evaluate] card ({t_card:.1f} s): "
          + json.dumps({k: round(float(v), 5) for k, v in card.items()})
          + f"; kernel launches {launched}, #2 in speaker_verification (card, then CPU) "
          f"{sv_launches}")
    print(f"[k3 evaluate] plain CPU ({t_cpu:.1f} s): "
          + json.dumps({k: round(float(v), 5) for k, v in cpu.items()})
          + "; relative loss errors " + json.dumps({k: float(f"{v:.2e}") for k, v in errs.items()})
          + f" (tolerance {EVAL_LOSS_TOL}); embeddings max |card - CPU| {emb_err:.2e} (tolerance "
          f"{EMB_TOL}); sv_eer {card['sv_eer']:.4f} vs {cpu['sv_eer']:.4f} "
          f"(tolerance {EER_TOL}); own / cross cosine {card['sv_own_cos']:.4f} / "
          f"{card['sv_cross_cos']:.4f} vs {cpu['sv_own_cos']:.4f} / {cpu['sv_cross_cos']:.4f} "
          f"(tolerance {COS_TOL}) ({_smi()})")
    if not all(math.isfinite(v) for v in (*card.values(), *cpu.values())):
        fails.append(f"[k3 evaluate] non-finite metrics {card} {cpu}")
    if max(errs.values()) > EVAL_LOSS_TOL:
        fails.append(f"[k3 evaluate] losses card {card} vs CPU {cpu}")
    if abs(card["sv_eer"] - cpu["sv_eer"]) > EER_TOL or emb_err > EMB_TOL or \
            max(abs(card[k] - cpu[k]) for k in ("sv_own_cos", "sv_cross_cos")) > COS_TOL:
        fails.append(f"[k3 evaluate] speaker verification card {card} vs CPU {cpu}")
    if not sv_launches or sv_launches[0] == 0:
        fails.append(f"[k3 evaluate] speaker_verification launched kernel #2 {sv_launches} times")
    for name in ("text_encoder_bilstm", "cbhg_bigru", "ge2e_lstm_layer"):
        if not launched.get(name):
            fails.append(f"[k3 evaluate] kernel {name} not launched by the evaluation")
    return fails


def _flat_tree(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _trees_equal(a: dict, b: dict) -> bool:
    import numpy as np

    fa, fb = _flat_tree(a), _flat_tree(b)
    return fa.keys() == fb.keys() and all(
        np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype and np.array_equal(fa[k], fb[k])
        for k in fa)


class _Tee:
    """stdout, with every line written also kept (``lines``)."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s):
        self.lines.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def convert_pass(params, batch_stats, meta, hp, wavs, kernels, work: pathlib.Path) -> list[str]:
    """Pass (l): a reference torch checkpoint, converted and served on the
    card. The port's reference torch model (``convert/reference_torch.py``)
    at the checkpoint's own hp, filled from its arrays by the inverse mapping
    (:func:`reference_models_from_tree`) and saved reference-style
    (``torch.save({"Model", "Steps"})``), is converted with
    ``convert_full_checkpoint`` and ``export_compact`` under that hp and
    loaded with ``Synthesizer.from_compact``. Gates: (1) the converted
    params bit-equal to the checkpoint's; (2) the four texts under the
    default decode and ``bf16_pallas`` decode the checkpoint's own mel
    lengths with mel, linear and wav bit-equal, the converted synthesizer
    launching #1, #2, #3, #5, #4 (and #6 under ``bf16_pallas``); (3) ``python
    -m multi_speaker_tts_tpu_torch.convert`` as a subprocess (default hp, the
    same widths) writes the API's params; (4) the reference model's
    teacher-forced forward on the card against the port's ``Tacotron`` of the
    converted weights in f32, prenet dropout 0 on both sides, 8 rows of the
    train batch: every output within 1e-3 of its peak (TF32 off). Returns
    the failures."""
    import numpy as np
    import torch

    from multi_speaker_tts_tpu_torch.checkpoints import load_compact
    from multi_speaker_tts_tpu_torch.convert.mapping import convert_full_checkpoint
    from multi_speaker_tts_tpu_torch.convert.reference_torch import (
        build_reference_ge2e, build_reference_tacotron, save_reference_checkpoint,
    )
    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.tools.torch_parity import converted_models
    from multi_speaker_tts_tpu_torch.train.checkpoints import export_compact

    fails = []
    t0 = time.perf_counter()
    taco_ref, ge2e_ref = reference_models_from_tree(params, batch_stats, hp)
    n_params = sum(t.numel() for m in (taco_ref, ge2e_ref) for t in m.parameters())
    steps = int(meta.get("trained_steps", 0))
    src = work / f"S_{steps}.pt"
    save_reference_checkpoint(str(src), tacotron=taco_ref, ge2e=ge2e_ref, steps=steps)
    tree = convert_full_checkpoint(str(src), hp)
    dst = work / "converted.msgpack"
    export_compact(dst, tree["params"], tree["batch_stats"],
                   meta={"hp": hp.to_dict(), "source": str(src), "trained_steps": tree["step"]})
    p_conv, b_conv, meta_conv = load_compact(dst)
    gate1 = (_trees_equal(tree["params"], params) and _trees_equal(tree["batch_stats"], batch_stats)
             and _trees_equal(p_conv, params) and _trees_equal(b_conv, batch_stats))
    print(f"[l convert] reference torch model {n_params / 1e6:.2f}M params, saved "
          f"({src.stat().st_size / 1e6:.1f} MB), converted and exported "
          f"({dst.stat().st_size / 1e6:.1f} MB, step {meta_conv.get('trained_steps')}) in "
          f"{time.perf_counter() - t0:.1f} s; params and batch_stats bit-equal to the "
          f"checkpoint's: {gate1}")
    if not gate1:
        fails.append("[l convert] converted params differ from the checkpoint's")

    want = ("mel_frontend", "ge2e_lstm_layer", "text_encoder_bilstm", "cbhg_bigru",
            "griffin_lim_staged")
    for quantize in (None, "bf16_pallas"):
        label = quantize or "default"
        conv = Synthesizer.from_compact(str(dst), seed=0, quantize=quantize)
        orig = Synthesizer(hp, params, batch_stats, seed=0, quantize=quantize)
        for k in kernels.values():
            k.launches = 0
        out_c = conv.synthesize(TEXTS, conv.enroll(wavs), pcm16=True)
        torch.cuda.synchronize()
        counts = {name: k.launches for name, k in kernels.items()}
        out_o = orig.synthesize(TEXTS, orig.enroll(wavs), pcm16=True)
        lens_c, lens_o = ([o["mel_length"] for o in out] for out in (out_c, out_o))
        equal = {key: all(np.array_equal(a[key], b[key]) for a, b in zip(out_c, out_o))
                 for key in ("mel", "linear", "wav")}
        need = want + (("decode_segment_bf16",) if quantize else ())
        print(f"[l convert] {label}: mel_lengths {lens_c} (the checkpoint's {lens_o}); "
              f"bit-equal {equal}; launches " + json.dumps({n: counts[n] for n in need}))
        if lens_c != lens_o or not all(equal.values()):
            fails.append(f"[l convert] {label}: lengths {lens_c} vs {lens_o}, equal {equal}")
        missing = [n for n in need if counts[n] == 0]
        if missing:
            fails.append(f"[l convert] {label}: kernels not launched: {missing}")
        del conv, orig

    cli_out = work / "converted_cli.msgpack"
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "multi_speaker_tts_tpu_torch.convert", "-in", str(src),
         "-out", str(cli_out)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True, text=True,
        timeout=600)
    cli_ok = res.returncode == 0 and cli_out.exists()
    cli_equal = cli_ok and _trees_equal(load_compact(cli_out)[0], p_conv)
    print(f"[l convert] CLI (default hp) in {time.perf_counter() - t0:.1f} s: rc "
          f"{res.returncode}, {res.stdout.strip()[-120:]!r}; params equal to the API's: "
          f"{cli_equal}")
    if not cli_equal:
        fails.append(f"[l convert] CLI: rc {res.returncode}, equal {cli_equal}: "
                     f"{res.stderr[-400:]}")

    hp32 = hp.replace(Train={"Use_Mixed_Precision": False},
                      Decoder={"Prenet": {"Dropout_Rate": 0.0}})
    taco_t, ge2e_t = build_reference_tacotron(hp32), build_reference_ge2e(hp32)
    taco_t.load_state_dict(taco_ref.state_dict())
    ge2e_t.load_state_dict(ge2e_ref.state_dict())
    taco_t, ge2e_t = taco_t.cuda().eval(), ge2e_t.cuda().eval()
    for m in (*taco_t.modules(), *ge2e_t.modules()):
        if isinstance(m, torch.nn.RNNBase):
            m.flatten_parameters()  # one cuDNN weight buffer, as loaded weights are not
    taco_p, ge2e_p = converted_models(tree, hp32, torch.device("cuda"))
    batch = {k: torch.from_numpy(np.asarray(v)).cuda()
             for k, v in _train_batch(hp, 8, seed=0).items()}
    args = (batch["tokens"].long(), batch["token_lengths"].long(), batch["mels"])
    t0 = time.perf_counter()
    with torch.no_grad():
        spk_t, spk_p = ge2e_t(batch["ref_mels"]), ge2e_p(batch["ref_mels"])
        out_t = taco_t(*args, spk_t)
        out_p = taco_p(*args, spk_p)
    torch.cuda.synchronize()
    errs = {k: ((out_p[k] - out_t[k]).abs().max() / out_t[k].abs().max()).item()
            for k in ("mel_pre", "mel_post", "stop_logits", "alignments", "linear")}
    errs["speaker_embedding"] = ((spk_p - spk_t).abs().max() / spk_t.abs().max()).item()
    print(f"[l convert] teacher-forced forward, reference torch model against the port's "
          f"Tacotron (f32, prenet dropout 0, B 8, mels {tuple(batch['mels'].shape)}; "
          f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}, "
          f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}) "
          f"in {time.perf_counter() - t0:.1f} s: max |port - torch| / max |torch| "
          + json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()}) + " (tolerance 1e-3)")
    if not all(v <= 1e-3 for v in errs.values()):
        fails.append(f"[l convert] forward parity: {errs}")
    return fails


def f32_pass(params, batch_stats, hp, wavs, kernels) -> list[str]:
    """Pass (m): the same checkpoint as f32 (``Train.Use_Mixed_Precision:
    false``, the same arrays) on the card, by the reference's routing: the
    recurrences on the plain route (the three dispatchers print their
    ``[dispatch] ... -> plain`` lines), the mel front-end and Griffin-Lim
    on their kernels. Enroll and synthesize the four texts with the
    fixed-length decode, the prenet masks drawn on the CPU for both devices:
    lengths equal and mel within 1e-3 of the port's CPU f32 synthesis (on
    the card's embedding; the CPU does not vocode), wavs finite; #1 and #4
    launched, #2, #3, #5 not. ``bf16_pallas`` on the f32 checkpoint runs
    (#6 launched, the recurrences plain). One train step at B 8, f32, dropout 0, GE2E
    trainable, against the CPU's: losses within 1e-4 relative, the
    gradient norm within 1e-3; no recurrence kernel launched, forward,
    residual or backward. Each kernel wrapper called directly on f32 CUDA
    inputs raises. Returns the failures."""
    import contextlib

    import numpy as np
    import torch

    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.inference import Synthesizer, prenet_mask_sampler
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel, lstm_kernel
    from multi_speaker_tts_tpu_torch.ops.gru import GRUParams
    from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams
    from multi_speaker_tts_tpu_torch.train.trainer import Trainer

    fails = []
    hp32 = hp.replace(Train={"Use_Mixed_Precision": False})
    recurrences = ("ge2e_lstm_layer", "text_encoder_bilstm", "cbhg_bigru")
    train_kernels = ("ge2e_lstm_layer_residuals", "ge2e_lstm_bwd",
                     "text_encoder_bilstm_residuals", "text_encoder_bilstm_bwd",
                     "cbhg_bigru_residuals", "cbhg_bigru_bwd")

    def cpu_masks(synth):
        synth._prenet_masks = lambda batch: prenet_mask_sampler(
            synth.hp, torch.device("cpu"), synth.seed, batch)
        return synth

    card = cpu_masks(Synthesizer(hp32, params, batch_stats, seed=0))
    for op in ("ge2e_lstm", "bilstm", "bigru"):
        dsp._DISPATCH_LOGGED.discard((op, "plain"))
    for k in kernels.values():
        k.launches = 0
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        emb = card.enroll(wavs)
        out_card = card.synthesize(TEXTS, emb, early_exit=False)
        torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    counts = {name: k.launches for name, k in kernels.items()}
    lines = [ln.strip() for ln in "".join(tee.lines).splitlines() if "-> plain" in ln]
    t0 = time.perf_counter()
    cpu = cpu_masks(Synthesizer(hp32, params, batch_stats, seed=0, device="cpu"))
    out_cpu = cpu.synthesize(TEXTS, emb, early_exit=False, vocode=False)
    t_cpu = time.perf_counter() - t0
    emb_cpu = Synthesizer(hp32, params, batch_stats, seed=0, device="cpu").enroll(wavs)
    cos = float((emb * emb_cpu).sum())
    lens = [o["mel_length"] for o in out_card]
    lens_cpu = [o["mel_length"] for o in out_cpu]
    mel_err = max(float(np.abs(a["mel"] - b["mel"]).max()) for a, b in zip(out_card, out_cpu))
    finite = all(np.isfinite(o["wav"]).all() and o["wav"].size > 0 for o in out_card)
    shown = {n: counts[n] for n in ("mel_frontend", *recurrences, "griffin_lim_staged")}
    print(f"[m f32] dispatch lines {lines}; launches " + json.dumps(shown)
          + f"; fixed-length decode, bucket {card.last_decode_bucket}, mel_lengths {lens} "
          f"(CPU {lens_cpu}); mel max |card - CPU| {mel_err:.3e} (tolerance 1e-3); wavs finite "
          f"{finite}; embedding cosine to the CPU's {cos:.7f}; card {t_card * 1e3:.1f} ms "
          f"(enroll + synthesize + vocode), CPU synthesize {t_cpu:.1f} s")
    if len(lines) != 3:
        fails.append(f"[m f32] dispatch lines: {lines}")
    if not (counts["mel_frontend"] and counts["griffin_lim_staged"]) or any(
            counts[n] for n in recurrences):
        fails.append(f"[m f32] launches {shown}")
    if lens != lens_cpu or not mel_err <= 1e-3 or not finite or not cos >= 0.999:
        fails.append(f"[m f32] synthesis: lengths {lens} vs {lens_cpu}, mel {mel_err}, "
                     f"finite {finite}, cosine {cos}")
    del card, cpu

    # bf16_pallas on the f32 checkpoint: the decode kernel with the gates in
    # bf16, as the JAX package allows (ADVICE.md items 1 and 3); the
    # recurrences stay on the plain route.
    synth_b = Synthesizer(hp32, params, batch_stats, seed=0, quantize="bf16_pallas")
    for k in kernels.values():
        k.launches = 0
    out_b = synth_b.synthesize(TEXTS, emb)
    torch.cuda.synchronize()
    counts = {n: kernels[n].launches for n in ("decode_segment_bf16", *recurrences)}
    finite_b = all(np.isfinite(o["wav"]).all() and o["mel_length"] > 0 for o in out_b)
    print(f"[m f32] bf16_pallas on the f32 checkpoint: runs, mel_lengths "
          f"{[o['mel_length'] for o in out_b]}, wavs finite {finite_b}; launches {counts}")
    if not counts["decode_segment_bf16"] or any(counts[n] for n in recurrences) or not finite_b:
        fails.append(f"[m f32] bf16_pallas: launches {counts}, finite {finite_b}")
    del synth_b

    no_dropout = dict(Decoder={"Prenet": {"Dropout_Rate": 0.0}},
                      Encoder={"Conv": {"Dropout_Rate": 0.0}},
                      Postnet={"Conv": {"Dropout_Rate": 0.0}},
                      Linear_Head={"Conv": {"Dropout_Rate": 0.0}},
                      Speaker_Embedding={"GE2E": {"Freeze": False}})
    hp_t = hp32.replace(**no_dropout)
    batch = _train_batch(hp, 8, seed=0)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    on_card = Trainer.from_params(hp_t, params, batch_stats, seed=0).train_step(batch)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    counts = {n: kernels[n].launches for n in (*recurrences, *train_kernels)}
    on_cpu = Trainer.from_params(hp_t, params, batch_stats, device="cpu", seed=0).train_step(batch)
    errs = {k: abs(on_card[k] - on_cpu[k]) / max(abs(on_cpu[k]), 1e-12)
            for k in on_cpu if k != "skipped_nonfinite"}
    print(f"[m f32] train step B 8 (f32, dropout 0, GE2E trainable) in {t_step * 1e3:.1f} ms "
          f"(first step, with its set-up): grad_norm {on_card['grad_norm']:.4f} vs CPU "
          f"{on_cpu['grad_norm']:.4f}; relative errors "
          + json.dumps({k: float(f"{v:.2e}") for k, v in errs.items()})
          + f" (tolerance 1e-4 each loss, 1e-3 grad_norm); recurrence launches {counts}")
    for k, v in errs.items():
        if not v <= (1e-3 if k == "grad_norm" else 1e-4):
            fails.append(f"[m f32] train step {k}: card {on_card[k]} vs CPU {on_cpu[k]}")
    if any(counts.values()) or on_card["skipped_nonfinite"]:
        fails.append(f"[m f32] train step: launches {counts}, metrics {on_card}")

    T, B, H = 5, 2, 128
    z = lambda *s: torch.zeros(s, device="cuda")  # noqa: E731
    p = LSTMParams(z(H, 4 * H), z(H, 4 * H), z(4 * H))
    g = GRUParams(z(H, 3 * H), z(H, 3 * H), z(3 * H), z(3 * H))
    f32 = torch.float32
    direct = {
        "lstm_seq_layer_fwd": lambda: lstm_kernel.lstm_seq_layer_fwd(p, z(T, B, H), f32),
        "lstm_seq_layer_bwd": lambda: lstm_kernel.lstm_seq_layer_bwd(
            p.w_hh, z(T, B, 4 * H), z(T, B, H), None, z(T, B, H), f32),
        "bilstm_recurrence": lambda: birnn_kernel.bilstm_recurrence(
            z(T, B, 4 * H), z(T, B, 4 * H), p.w_hh, p.w_hh, f32),
        "bilstm_bwd": lambda: birnn_kernel.bilstm_bwd(
            *[z(T, B, n) for n in (4 * H, H, 4 * H, H)], p.w_hh, p.w_hh, z(T, B, H),
            z(T, B, H), f32),
        "bigru_recurrence": lambda: birnn_kernel.bigru_recurrence(
            z(T, B, 3 * H), z(T, B, 3 * H), g, g, f32),
        "bigru_bwd": lambda: birnn_kernel.bigru_bwd(
            *[z(T, B, n) for n in (3 * H, 3 * H, H)] * 2, g.w_hh, g.w_hh, z(T, B, H),
            z(T, B, H), f32),
    }
    raised = {}
    for name, call in direct.items():
        try:
            call()
            raised[name] = "returned"
        except NotImplementedError:
            raised[name] = "raised"
    print(f"[m f32] the kernel wrappers called directly on f32 CUDA inputs: {raised}")
    if any(v != "raised" for v in raised.values()):
        fails.append(f"[m f32] direct f32 calls: {raised}")
    return fails


def tools_pass(work: pathlib.Path) -> list[str]:
    """Pass (n): the port's tools, each through ``main(argv)`` on the card:
    ``tools/stream_quality.py`` on the small Conv-head checkpoint (its three
    numbers), ``tools/profile_train.py`` on the train step at pass (j)'s
    shapes (its per-category table), ``ge2e_roofline`` at the base shape (16
    x 10 x 160), ``decode_probe -steps 128``, ``gates_probe``,
    ``decode_kernel_ab`` at S 48 and 1024, and ``sv_harmonic_control`` on
    pass (j)'s export (with (k3)'s GE2E windows of its crops) and corpus
    under ``work``. Recording is off while they run. Gates: finite numbers,
    positive times; the decoder scan's forward and backward each timed once
    a step; the decode kernel launched in the kernel variants. Returns the
    failures."""
    import math

    from multi_speaker_tts_tpu_torch.checkpoints import load_compact
    from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
    from multi_speaker_tts_tpu_torch.ops import decode_kernel
    from multi_speaker_tts_tpu_torch.tools import (
        decode_kernel_ab, decode_probe, gates_probe, ge2e_roofline, profile_train,
        stream_quality, sv_harmonic_control,
    )
    from multi_speaker_tts_tpu_torch.train.checkpoints import export_compact

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        return out, f"[n {name}] {time.perf_counter() - t0:.1f} s"

    def times_ok(report, keys):
        return all(isinstance(report.get(k), float) and math.isfinite(report[k])
                   and report[k] > 0 for k in keys)

    fails = []
    sq, head = timed("stream_quality", lambda: stream_quality.main(
        ["-ckpt", str(ROOT / "demo" / "serving_ckpt.msgpack")]))
    keys = ("wav_mel_l1_batch", "wav_mel_l1_stream_crossfade", "wav_mel_l1_stream_warmstart")
    print(f"{head} on {sq['device']}: " + json.dumps({k: sq[k] for k in keys}))
    if sq["device"] != "cuda" or not all(math.isfinite(sq[k]) and sq[k] > 0 for k in keys):
        fails.append(f"[n stream_quality] {sq}")
    pt, head = timed("profile_train", lambda: profile_train.main(["-steps", "2"]))
    sh = pt["scan_host_ms"]
    print(f"{head}: step {pt['step_ms']:.2f} ms "
          f"(CUDA events), wall {pt['step_wall_ms']:.2f} ms; decoder scan host ms forward "
          f"{sh['forward']:.2f}, backward {sh['backward']:.2f} "
          f"({100 * sh['share_of_step_wall']:.1f}% of the wall); device busy "
          f"{pt['device_busy_ms_per_step']} ms a step, {pt['device_ops_per_step']} device ops "
          f"(the profiler's; CUPTI does not see the card in every environment)")
    if (pt["device"] != "cuda" or not math.isfinite(pt["step_ms"])
            or sh["calls_per_step"] != {"forward": 1.0, "backward": 1.0}):
        fails.append(f"[n profile_train] {pt}")

    (g2,), head = timed("ge2e_roofline", lambda: ge2e_roofline.main([]))
    print(f"{head}: " + json.dumps(g2))
    if g2["device"] != "cuda" or not times_ok(g2, ("ms_per_step", "mfu", "frames_per_sec")):
        fails.append(f"[n ge2e_roofline] {g2}")

    before = {m: k.launches for m, k in decode_kernel.KERNELS.items()}
    dp, head = timed("decode_probe", lambda: decode_probe.main(["-steps", "128"]))
    launched = {m: k.launches - before[m] for m, k in decode_kernel.KERNELS.items()}
    print(f"{head}: decode kernel launches {launched}; " + json.dumps(dp))
    dp_keys = [k for k in dp if k.startswith(("decode_ms_", "us_per_step_"))]
    if (dp["device"] != "cuda" or len(dp_keys) != 16 or not times_ok(dp, dp_keys)
            or not all(launched.values())):
        fails.append(f"[n decode_probe] launches {launched}, {dp}")

    gp, head = timed("gates_probe", lambda: gates_probe.main([]))
    print(f"{head}: " + json.dumps(gp))
    if gp["device"] != "cuda" or not times_ok(gp, ("gates_us_per_step_bf16",
                                                   "gates_us_per_step_int8_xla")):
        fails.append(f"[n gates_probe] {gp}")

    variants = ("xla_bf16", "xla_int8", "pallas_int8", "pallas_bf16")
    for S in (48, 1024):
        ab, head = timed(f"decode_kernel_ab S {S}", lambda: decode_kernel_ab.main(["-S", str(S)]))
        print(f"{head}: " + json.dumps(ab))
        if (ab["device"] != "cuda" or not times_ok(ab, [f"us_per_step_{v}" for v in variants])
                or not (ab["launches_per_run_pallas_int8"] and ab["launches_per_run_pallas_bf16"])):
            fails.append(f"[n decode_kernel_ab S {S}] {ab}")

    # (j)'s export with GE2E windows of its crops, as (k3) evaluates it: a
    # 160-frame window over these 35-103-frame utterances embeds them alike.
    params_j, stats_j, meta_j = load_compact(work / "export.msgpack")
    export_compact(work / "export_sv.msgpack", params_j, stats_j, dict(
        meta_j, hp=Recursive_Parse(meta_j["hp"]).replace(Speaker_Embedding={"GE2E": {
            "Window_Length": EVAL_WINDOW, "Window_Shift": EVAL_SHIFT}}).to_dict()))
    sv, head = timed("sv_harmonic_control", lambda: sv_harmonic_control.main(
        ["-checkpoint", str(work / "export_sv.msgpack"), "-pattern",
         str(work / "corpus" / "patterns")]))
    print(f"{head}: " + json.dumps({k: v for k, v in sv.items() if k != "pairs"}))
    numbers = [v for k, v in sv.items() if isinstance(v, float)]
    if sv["device"] != "cuda" or not all(math.isfinite(v) for v in numbers):
        fails.append(f"[n sv_harmonic_control] {sv}")
    return fails


def text_of(S: int, hp) -> str:
    """A text of PARAGRAPH whose token bucket is S (a multiple of 16): its
    tokens, a character each and one more, are more than S - 16."""
    from multi_speaker_tts_tpu_torch.text import encode_text

    text = (PARAGRAPH * (S // len(PARAGRAPH) + 2))[:S - 2].strip()
    n = len(encode_text(text, hp))
    if not S - 16 < n <= S:
        raise ValueError(f"a text of {n} tokens for a bucket of {S}")
    return text


def long_text_pass(params, batch_stats, hp, wavs, kernels, recorded, plain_calls, post_json):
    """Pass (o): long texts on the checkpoint as it is, under the default
    decode, ``bf16_pallas`` and ``int8_pallas``: 16 texts (TEXTS, MORE_TEXTS
    and a first one of 206 characters: S 208), one text of S 1008, one at
    each kernel mode's one-row limit (the largest multiple of 16 at which a
    launch over one row fits, ``decode_kernel.max_positions``) and one past
    the bf16 limit. Gates: no call raises; under a kernel mode the decode
    kernel launches once a row group (``kernel_row_groups``) a chunk and no
    plain step runs, and past the limit it launches not at all and one
    ``[dispatch] decode ... -> plain`` line is printed; the same request
    twice gives the same lengths; wavs finite. Then a burst of the 16 texts
    to a ``bf16_pallas`` daemon, all answered 200. Returns (the failures,
    {mode: {S: the first chunk's recorded kernel arguments}}) for the
    kernel phase."""
    import concurrent.futures
    import contextlib
    import io

    import numpy as np
    import torch

    from multi_speaker_tts_tpu_torch import serve
    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.ops import decode_kernel

    fails, chunks = [], {}
    dev = torch.device("cuda")
    card = decode_kernel.card_limits(dev)
    synth = Synthesizer(hp, params, batch_stats, seed=0)
    dec = synth.tacotron.decoder
    widths = decode_kernel.widths_of(decode_kernel.prepare_bundle(
        dec.params(), [(d.kernel, d.bias) for d in dec.prenet], quantize=False))
    limit = {m: decode_kernel.max_positions(widths, m == "int8", *card) for m in ("bf16", "int8")}
    emb = synth.enroll(wavs)
    del synth
    past = -(-(limit["bf16"] + 1) // 16) * 16
    texts16 = [text_of(208, hp)] + TEXTS + MORE_TEXTS[:11]
    cases = {"s208": (208, texts16), "s1008": (1008, [text_of(1008, hp)]),
             "past": (past, [text_of(past, hp)])}
    print(f"[o long texts] the decode kernel's one-row limit on this card ({_smi()}): "
          f"{limit['bf16']} memory positions in bf16, {limit['int8']} in int8; past it the "
          f"plain loop (the text past the limit: S {past}); rows a launch at S 208: "
          + ", ".join(f"{m} {decode_kernel.group_rows(208, widths, m == 'int8', *card)}"
                      for m in ("bf16", "int8")))
    decodes = ("decode_segment_bf16", "decode_segment_int8")
    for label, quantize in (("default", None), ("bf16_pallas", "bf16_pallas"),
                            ("int8_pallas", "int8_pallas")):
        mode = quantize.split("_")[0] if quantize else None
        synth = Synthesizer(hp, params, batch_stats, seed=0, quantize=quantize)
        mine = dict(cases)
        if mode:
            at = limit[mode] // 16 * 16
            mine["limit"] = (at, [text_of(at, hp)])
        dsp._DISPATCH_LOGGED.discard(("decode", "plain"))
        for case, (S, texts) in mine.items():
            for store in (*recorded.values(), *plain_calls.values()):
                store.clear()
            for k in kernels.values():
                k.launches = 0
            buf = io.StringIO()
            try:
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    out = synth.synthesize(texts, emb)
                    torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                launches = {n: kernels[n].launches for n in decodes}
                calls = list(recorded["decode_segment_bf16"])  # both modes' wrapper
                plain_steps = sum(len(v) for v in plain_calls.values())
                again = synth.synthesize(texts, emb)
            except Exception as e:  # a gate: no call raises
                sys.stdout.write(buf.getvalue())
                fails.append(f"[o {label}] {case} (S {S}) raised {type(e).__name__}: {e}")
                continue
            sys.stdout.write(buf.getvalue())
            dispatch = [x for x in buf.getvalue().splitlines() if x.startswith("[dispatch] decode")]
            lengths = [o["mel_length"] for o in out]
            groups = [len(decode_kernel.kernel_row_groups(a[0], *a[1].shape[:2], dev))
                      for a, _, _ in calls]
            want = sum(groups)
            got = launches[f"decode_segment_{mode}"] if mode else sum(launches.values())
            routed = bool(mode) and S > limit[mode]
            print(f"[o {label}] {case}: S {S}, {len(texts)} text(s), mel_lengths {lengths}, "
                  f"{ms:.1f} ms; decode launches {launches} for {len(calls)} chunks "
                  f"({groups[:1]} row groups a chunk); plain decode steps {plain_steps}; dispatch "
                  f"lines {dispatch}")
            if routed or not mode:
                if any(launches.values()) or not plain_steps:
                    fails.append(f"[o {label}] {case}: decode launches {launches}, plain steps "
                                 f"{plain_steps}: the plain loop should run, no kernel")
                if routed != bool(dispatch) or len(dispatch) > 1 or (
                        dispatch and "-> plain" not in dispatch[0]):
                    fails.append(f"[o {label}] {case}: dispatch lines {dispatch}")
            else:
                if not calls or got != want or plain_steps or any(
                        a[1].shape[1] != S for a, _, _ in calls):
                    fails.append(f"[o {label}] {case}: {got} launches for {len(calls)} chunks, "
                                 f"want {want}; plain steps {plain_steps}")
                elif case != "past":
                    chunks.setdefault(mode, {})[S] = calls[0][0]
            if [o["mel_length"] for o in again] != lengths:
                fails.append(f"[o {label}] {case}: the same request decoded "
                             f"{[o['mel_length'] for o in again]}, then {lengths}")
            if not all(np.isfinite(o["wav"]).all() and o["mel_length"] > 0 for o in out):
                fails.append(f"[o {label}] {case}: a wav is not finite or a length is 0")
        del synth
    # The daemon: a burst of the 16 texts under bf16_pallas.
    synth = Synthesizer(hp, params, batch_stats, seed=0, quantize="bf16_pallas")
    daemon = serve.TTSServer(synth, host="127.0.0.1", port=0, max_batch=16, max_wait_ms=250.0,
                             pcm16=True)
    daemon.start_background()
    before = kernels["decode_segment_bf16"].launches
    try:
        daemon.registry.register("spk0", emb)
        url = f"http://127.0.0.1:{daemon.port}/synthesize"
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(texts16)) as pool:
            replies = list(pool.map(lambda t: post_json(url, {"text": t, "speaker": "spk0"}),
                                    texts16))
        t_burst = time.perf_counter() - t0
    finally:
        daemon.shutdown()
    statuses = [st for st, _, _ in replies]
    print(f"[o daemon] a burst of {len(texts16)} /synthesize under bf16_pallas, the longest "
          f"{len(texts16[0])} characters: statuses {statuses}, {t_burst * 1e3:.1f} ms wall, "
          f"bf16 decode launches {kernels['decode_segment_bf16'].launches - before} ({_smi()})")
    if statuses != [200] * len(texts16) or kernels["decode_segment_bf16"].launches == before:
        fails.append(f"[o daemon] statuses {statuses}")
    return fails, chunks


# -- Pass (p): the kernels at every batch and width the reference's gates admit --

# (p1) GE2E's published batch (N 64 speakers x M 10 utterances, 160-frame
# crops) at the repo's GE2E widths (768 x 3); (p2) a decoder LSTM of 1536,
# attention 640 and a CBHG GRU_Size of 512 (256 a direction), the production
# widths otherwise; the mel front-end at n_fft outside 256-4096.
P1_N, P1_M, P1_FRAMES = 64, 10, 160
P2_HP = {"Decoder": {"LSTM": {"Sizes": 1536}, "Attention": {"Size": 640}},
         "Linear_Head": {"CBHG": {"GRU_Size": 512}}}
P2_STEPS = 64
# (n_fft, hop) of the mel rows: the FFT route below 256 and past 4096 (its
# global-memory mode at 32768), the DFT route at 6000 and (global) 17000.
P3_MEL = {"mel_frontend_small": [(32, 8), (128, 32)],
          "mel_frontend_large": [(8192, 2048), (16384, 4096)],
          "mel_frontend_dft_6000": [(6000, 1500)],
          "mel_frontend_global": [(32768, 8192)],
          "mel_frontend_dft_global": [(17000, 4250)]}


def _p1_mels(hp, n_rows: int, frames: int, seed: int):
    """Seeded speech-like clips on the card: speaker s a pitch and a
    spectral tilt, each utterance its own jitter of both, 20 harmonics and a
    little noise; through the port's front-end (its mel kernel) and cut to
    ``frames`` frames, rows grouped by speaker."""
    import torch

    from multi_speaker_tts_tpu_torch.audio import dsp

    cfg = dsp.DSPConfig.from_hp(hp)
    g = torch.Generator(device="cuda").manual_seed(seed)
    L = cfg.hop * (frames + 8)
    spk = torch.arange(n_rows, device="cuda") // P1_M
    n_spk = int(spk.max()) + 1
    f0_s = 90.0 + 160.0 * torch.rand(n_spk, device="cuda", generator=g)
    tilt_s = 0.15 + 0.35 * torch.rand(n_spk, device="cuda", generator=g)
    f0 = f0_s[spk] * (1.0 + 0.03 * torch.randn(n_rows, device="cuda", generator=g))
    tilt = tilt_s[spk] * (1.0 + 0.1 * torch.randn(n_rows, device="cuda", generator=g))
    t = torch.arange(L, device="cuda") / cfg.sample_rate
    wav = 0.01 * torch.randn(n_rows, L, device="cuda", generator=g)
    for k in range(1, 21):
        phase = 2 * math.pi * torch.rand(n_rows, 1, device="cuda", generator=g)
        wav += torch.exp(-tilt * k)[:, None] * torch.sin(2 * math.pi * k * f0[:, None] * t + phase)
    wav = 0.5 * wav / wav.abs().amax(dim=1, keepdim=True)
    return dsp.melspectrogram_auto(wav, cfg)[:, :frames].contiguous()


def _fresh_state(hp, work: pathlib.Path, label: str, seed: int):
    """A fresh ``Trainer`` at ``hp`` on the card, its weights set to a
    trained model's scale N(0, 0.02): (trainer, checkpoint_state())."""
    import torch

    from multi_speaker_tts_tpu_torch.train.trainer import Trainer

    tr = Trainer(hp, checkpoint_dir=str(work / label), log_dir=str(work / f"{label}_logs"),
                 device="cuda", seed=0)
    tr.initialize()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in tr.params:
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return tr, tr.checkpoint_state()


def widths_pass(kernels: dict, work: pathlib.Path) -> tuple[list, dict]:
    """Pass (p). (p1) one ``GE2ETrainer`` step at N 64 x M 10 on seeded
    clips (the LSTM backward launching in row groups), then the step's
    gradients again with the plain reverse pass in place of the kernel;
    (p2) a fresh ``Trainer`` at P2_HP, its weights set to a trained model's
    scale N(0, 0.02), through ``Synthesizer.from_state``: enroll ->
    synthesize (fixed length) -> Griffin-Lim of the untrimmed decode under
    ``bf16_pallas`` and ``int8_pallas``, twice each and bit-equal, and one
    train step of 8 rows (the wide BiGRU's residual mode and backward);
    (p3) ``dsp.melspectrogram_auto`` at each n_fft of P3_MEL. Counts zeroed
    just before each and read just after. Returns the failures and what the
    kernel phase's rows of this pass read."""
    import io

    import numpy as np
    import torch

    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.hparams import default_hparams
    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.ops import (
        _build, birnn_kernel, decode_kernel, decoder_scan, lstm_kernel, mel_kernel,
    )
    from multi_speaker_tts_tpu_torch.train.ge2e_trainer import GE2ETrainer

    fails, data = [], {"launches": {}}

    def counts():
        return {name: k.launches for name, k in kernels.items()}

    def moved(before):
        return {n: kernels[n].launches - before[n] for n in kernels
                if kernels[n].launches != before[n]}

    # (p1) ---------------------------------------------------------------
    t0 = time.perf_counter()
    hp = default_hparams(GE2E_Train={"Batch_Speakers": P1_N, "Batch_Utterances": P1_M,
                                     "Frame_Length": P1_FRAMES})
    trainer = GE2ETrainer(hp, checkpoint_dir=str(work / "p1_ge2e"), log_dir=str(work / "p1_logs"),
                          device="cuda", seed=0)
    mels = _p1_mels(hp, P1_N * P1_M, P1_FRAMES, seed=64)
    H = hp.Speaker_Embedding.GE2E.LSTM.Sizes
    layers = hp.Speaker_Embedding.GE2E.LSTM.Stacks
    groups = lstm_kernel.bwd_row_groups(1, H, P1_N * P1_M, _build.card_limits("cuda"))
    fwd_groups = lstm_kernel.fwd_row_groups(1, H, H, P1_N * P1_M, _build.card_limits("cuda"))
    bwd_calls = []
    torch.cuda.synchronize()
    before = counts()
    with _recorded((lstm_kernel, "lstm_seq_layer_bwd_kernel", bwd_calls, layers)):
        m = trainer.train_step(mels)
    torch.cuda.synchronize()
    launched = moved(before)
    bwd_args = [a for a, _, _ in bwd_calls]
    del bwd_calls
    data["launches"]["ge2e_lstm_bwd_640"] = launched.get("ge2e_lstm_bwd", 0)
    want = {"ge2e_lstm_layer_residuals": layers * len(fwd_groups),
            "ge2e_lstm_bwd": layers * len(groups)}
    print(f"[p1 ge2e] GE2ETrainer.train_step at N {P1_N} x M {P1_M} = {P1_N * P1_M} rows, "
          f"{P1_FRAMES}-frame crops, LSTM {H} x {layers}: loss {m['loss']:.6f}, w {m['w']:.5f}, "
          f"b {m['b']:.5f}; backward row groups {[g.stop - g.start for g in groups]}; launches "
          f"{launched}; {time.perf_counter() - t0:.1f} s")
    if not all(math.isfinite(v) for v in m.values()):
        fails.append(f"[p1 ge2e] metrics {m}")
    if {n: launched.get(n, 0) for n in want} != want or len(groups) < 2:
        fails.append(f"[p1 ge2e] launches {launched}, want {want} ({len(groups)} row groups)")
    # The step's gradients with the kernel and with the plain reverse pass
    # (on the card) in its place, the forward the same: the loss equal, the
    # gradient norm within 2e-2 (the whole-step gate) and dG of the first 8
    # rows of every layer within 1e-2 of the peak (the kernel's gate).
    dGs, grads = {"kernel": [], "plain": []}, {}
    for label, instead in (("kernel", None), ("plain", lstm_kernel.lstm_seq_layer_bwd_plain)):
        with _recorded((lstm_kernel, "lstm_seq_layer_bwd_kernel", dGs[label], layers, instead)):
            loss, g = trainer.gradients(mels)
        grads[label] = (float(loss), {k: v.float() for k, v in g.items()})
        dGs[label] = [out[:, :8].clone() for _, _, out in dGs[label]]
    torch.cuda.synchronize()
    dG_k, dG_p = dGs["kernel"], dGs["plain"]
    (lk, gk), (lp, gp) = grads["kernel"], grads["plain"]
    norm_k = float(torch.sqrt(sum((v * v).sum() for v in gk.values())))
    norm_p = float(torch.sqrt(sum((v * v).sum() for v in gp.values())))
    per = {k: float((gk[k] - gp[k]).abs().max() / gp[k].abs().max().clamp(min=1e-12))
           for k in gp}
    dg8 = max(float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-12))
              for a, b in zip(dG_k, dG_p))
    data["p1"] = {"loss": [lk, lp], "grad_norm": [norm_k, norm_p], "dG8": dg8,
                  "args": bwd_args, "groups": [g.stop - g.start for g in groups]}
    print(f"[p1 ge2e] kernel vs plain reverse pass: loss {lk:.7f} / {lp:.7f}, grad norm "
          f"{norm_k:.6g} / {norm_p:.6g} (rel {abs(norm_k - norm_p) / max(norm_p, 1e-12):.2e}), "
          f"dG of the first 8 rows {dg8:.2e} of the peak; per parameter (max |diff| / max |plain|) "
          + json.dumps({k: float(f"{v:.2e}") for k, v in per.items()}))
    if (abs(lk - lp) > 1e-2 * max(1.0, abs(lp)) or abs(norm_k - norm_p) > 2e-2 * norm_p
            or dg8 > 1e-2 or len(dG_k) != layers or len(dG_p) != layers):
        fails.append(f"[p1 ge2e] kernel vs plain backward: loss {lk} / {lp}, norm {norm_k} / "
                     f"{norm_p}, dG8 {dg8}")
    del trainer, mels, grads, gk, gp
    print(f"[p1 ge2e] took {time.perf_counter() - t0:.1f} s")

    # (p2) ---------------------------------------------------------------
    t0 = time.perf_counter()
    hp_w = default_hparams(**P2_HP)
    tr, state = _fresh_state(hp_w, work, "p2_wide", seed=1536)
    p2 = {"decode": {}, "bigru": [], "bigru_res": [], "bigru_bwd": []}
    saved_logged = set(dsp._DISPATCH_LOGGED)
    dsp._DISPATCH_LOGGED.clear()  # any plain route prints its line again
    log = io.StringIO()
    need = ("mel_frontend", "ge2e_lstm_layer", "text_encoder_bilstm", "cbhg_bigru_wide",
            "griffin_lim_staged")
    for quantize in ("bf16_pallas", "int8_pallas"):
        mode = quantize.split("_")[0]
        synth = Synthesizer.from_state(hp_w, state, quantize=quantize, seed=0)
        emb = synth.enroll([str(p) for p in ENROLL])
        # Fixed length: at random weights the stop logit fires at once, and
        # the kernel is to decode every step of the bucket.
        synth.synthesize(TEXTS[:1], emb, max_steps=16, early_exit=False,
                         pcm16=True)  # warm-up: packs the weights
        torch.cuda.synchronize()
        before = counts()
        dec, gru_calls, plain_steps, plain_segments = [], [], [], []
        with contextlib.redirect_stdout(log), _recorded(
                (decode_kernel, "decode_segment_kernel", dec, 1 << 30),
                (birnn_kernel, "bigru_recurrence_kernel", gru_calls, 1),
                (decoder_scan, "decoder_cell_step", plain_steps, 1 << 30),
                (decode_kernel, "decode_segment_plain", plain_segments, 1 << 30)):
            emb = synth.enroll([str(p) for p in ENROLL])
            # The whole fixed-length decode vocoded untrimmed, twice.
            runs = [synth.synthesize(TEXTS, emb, max_steps=P2_STEPS, early_exit=False,
                                     pcm16=True, split_vocode=False, return_device=True)
                    for _ in range(2)]
        torch.cuda.synchronize()
        launched = moved(before)
        plain_ran = {"decoder_cell_step": len(plain_steps),
                     "decode_segment_plain": len(plain_segments)}
        p2["decode"][mode] = dec[0][0] if dec else None
        if not p2["bigru"]:
            p2["bigru"] = [a for a, _, _ in gru_calls]
        data["launches"][f"decode_segment_{mode}_wide"] = launched.get(f"decode_segment_{mode}", 0)
        data["launches"]["cbhg_bigru_wide"] = (data["launches"].get("cbhg_bigru_wide", 0)
                                               + launched.get("cbhg_bigru_wide", 0))
        # Every chunk of the second run bit-equal to the first's (the kernel
        # is deterministic), and so the whole output.
        n = len(dec) // 2
        chunks_equal = n > 0 and len(dec) == 2 * n and all(
            torch.equal(x, y) for (_, _, r1), (_, _, r2) in zip(dec[:n], dec[n:])
            for x, y in zip(_tensors(r1), _tensors(r2)))
        out, again = runs
        outputs_equal = out.keys() == again.keys() and all(
            torch.equal(out[k], again[k]) for k in out)
        mel, wav = out["mel_post"], out["wav"]
        frames, hop = mel.shape[1], synth.dsp_cfg.hop
        wav_ok = (wav.dtype == torch.int16 and bool(torch.isfinite(mel).all())
                  and tuple(wav.shape) == (mel.shape[0], hop * (frames - 1)))
        lengths = out["mel_lengths"].tolist()
        print(f"[p2 wide] {quantize}: decoder LSTM {hp_w.Decoder.LSTM.Sizes}, attention "
              f"{hp_w.Decoder.Attention.Size}, CBHG GRU_Size {hp_w.Linear_Head.CBHG.GRU_Size}: "
              f"{n} decode chunks a run over {frames} frames, bit-equal on repeat: chunks "
              f"{chunks_equal}, outputs {outputs_equal}; stop lengths {lengths}; untrimmed int16 "
              f"wavs {tuple(wav.shape)} {wav_ok}; launches {launched}; plain decode calls "
              f"{plain_ran}")
        missing = [n for n in (*need, f"decode_segment_{mode}") if not launched.get(n)]
        if missing or any(plain_ran.values()) or not wav_ok or frames < P2_STEPS \
                or not chunks_equal or not outputs_equal:
            fails.append(f"[p2 wide] {quantize}: not launched {missing}, plain {plain_ran}, "
                         f"{frames} frames, wavs {wav_ok}, bit-equal on repeat: chunks "
                         f"{chunks_equal}, outputs {outputs_equal}")
        del synth
    # One train step of 8 rows: the wide BiGRU's residual mode and backward.
    batch = _train_batch(hp_w, 8, seed=0)
    before = counts()
    res_calls, bwd_calls = [], []
    with contextlib.redirect_stdout(log), _recorded(
            (birnn_kernel, "bigru_recurrence_kernel", res_calls, 1 << 30),
            (birnn_kernel, "bigru_bwd_kernel", bwd_calls, 1)):
        m = tr.train_step(batch)
    torch.cuda.synchronize()
    launched = moved(before)
    for n in ("cbhg_bigru_wide_residuals", "cbhg_bigru_wide_bwd"):
        data["launches"][n] = launched.get(n, 0)
    p2["bigru_res"] = [a for a, _, _ in res_calls if len(a) > 4 and a[4]][:1]
    p2["bigru_bwd"] = [a for a, _, _ in bwd_calls]
    print(f"[p2 wide] Trainer.train_step on 8 rows: loss {m.get('loss', m.get('total'))}, "
          f"launches {launched}")
    if not launched.get("cbhg_bigru_wide_residuals") or not launched.get("cbhg_bigru_wide_bwd") \
            or not all(math.isfinite(float(v)) for v in m.values() if isinstance(v, float)):
        fails.append(f"[p2 wide] train step: launches {launched}, metrics {m}")
    plain_lines = [ln for ln in log.getvalue().splitlines() if "[dispatch]" in ln]
    print(f"[p2 wide] [dispatch] lines: {plain_lines}")
    if any("-> plain" in ln for ln in plain_lines):
        fails.append(f"[p2 wide] a plain route ran: {plain_lines}")
    dsp._DISPATCH_LOGGED.update(saved_logged)
    data["p2"] = p2
    del tr, state
    print(f"[p2 wide] took {time.perf_counter() - t0:.1f} s")

    # (p3) the front-end's entry point at the mel rows' widths -------------
    import dataclasses

    t0 = time.perf_counter()
    cfg = dsp.DSPConfig.from_hp(default_hparams())
    rng = np.random.default_rng(3)
    mel_objs = {"mel_frontend_small": mel_kernel.KERNEL, "mel_frontend_large": mel_kernel.KERNEL,
                "mel_frontend_dft_6000": mel_kernel.DFT_KERNEL,
                "mel_frontend_global": mel_kernel.FFT_GLOBAL_KERNEL,
                "mel_frontend_dft_global": mel_kernel.DFT_GLOBAL_KERNEL}
    data["mel"] = {}
    for name, widths in P3_MEL.items():
        objs = {id(k): k for k in mel_objs.values()}.values()
        before = {id(k): k.launches for k in objs}
        calls = []
        with _recorded((mel_kernel, "melspectrogram_kernel", calls, 1 << 30)):
            for n_fft, hop in widths:
                wav = torch.from_numpy((rng.standard_normal((2, hop * 9)) * 0.3)
                                       .astype(np.float32)).cuda()
                dsp.melspectrogram_auto(wav, dataclasses.replace(cfg, n_fft=n_fft, hop=hop))
        torch.cuda.synchronize()
        launched = {k.name: k.launches - before[id(k)] for k in objs if k.launches != before[id(k)]}
        data["launches"][name] = launched.get(mel_objs[name].name, 0)
        data["mel"][name] = [a for a, _, _ in calls]
        print(f"[p3 mel] {name}: dsp.melspectrogram_auto at (n_fft, hop) {widths}: launches "
              f"{launched}")
        if launched != {mel_objs[name].name: len(widths)}:
            fails.append(f"[p3 mel] {name}: launches {launched}")
    print(f"[p3 mel] took {time.perf_counter() - t0:.1f} s")
    return fails, data


# -- Pass (q): the LSTM family at every width the JAX gate admits, and the --
# -- reference's routes where both gates refuse ------------------------------

# (q1) a GE2E LSTM of 1792 x 3 (past the resident forward and past one
# backward row), 16 speakers x 10 utterances of 160-frame crops; (q2) a text
# encoder BiLSTM of 2304 (1152 a direction) and a GE2E LSTM of 1792 through
# the synthesizer and one train step; (q3) one routed case each where the
# port's kernel and the JAX gate both refuse.
Q1_N, Q1_M, Q1_FRAMES, Q1_H = 16, 10, 160, 1792
Q2_HP = {"Encoder": {"LSTM_Size": 2304},
         "Speaker_Embedding": {"GE2E": {"LSTM": {"Sizes": 1792}}}}
Q2_STEPS = 32
Q3_HP = {"Decoder": {"LSTM": {"Sizes": 2176}}, "Linear_Head": {"CBHG": {"GRU_Size": 2520}}}
# (n_fft, hop, T) of the Griffin-Lim routed to GEMM past the JAX package's cap
# for the staged kernel (n_fft 1024) and for the dense one (4096).
Q3_GL = [(1024, 256, 1300), (4096, 512, 400)]


def lstm_family_pass(kernels: dict, work: pathlib.Path) -> tuple[list, dict]:
    """Pass (q). (q1) one ``GE2ETrainer`` step at Q1_H on seeded clips (#2r
    and #8 on their wide routes, counted a row group), then the step's
    gradients again with the plain reverse pass in place of #8 (p1's
    gates); (q2) a fresh ``Trainer`` at Q2_HP through
    ``Synthesizer.from_state``: enroll -> synthesize (fixed length) ->
    Griffin-Lim, then one train step of 8 rows (#2, #2r, #3, #3r, #8, #9 on
    their wide routes; no ``[dispatch] ... -> plain`` line); (q3) the routed
    cases: Griffin-Lim at each of Q3_GL, and a synthesizer at Q3_HP (bf16
    decode past H 2048, BiGRU at H 1260 a direction), each with its
    ``[dispatch]`` line and no launch of the refused kernel. Counts zeroed
    just before each and read just after. Returns the failures and what the
    kernel phase's rows of this pass read."""
    import io

    import numpy as np
    import torch

    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.hparams import default_hparams
    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.ops import (
        _build, birnn_kernel, griffin_lim_kernel, griffin_lim_staged, lstm_kernel, stft_matmul,
    )
    from multi_speaker_tts_tpu_torch.train.ge2e_trainer import GE2ETrainer

    fails, data = [], {"launches": {}}
    card = _build.card_limits("cuda")
    objs = {"ge2e_lstm": lstm_kernel.KERNEL, "ge2e_lstm_residuals": lstm_kernel.RES_KERNEL,
            "ge2e_lstm_bwd": lstm_kernel.BWD_KERNEL, "bilstm": birnn_kernel.KERNEL,
            "bilstm_residuals": birnn_kernel.RES_KERNEL, "bilstm_bwd": birnn_kernel.BWD_KERNEL}
    refused = {k: v for k, v in kernels.items() if k.startswith(("decode", "cbhg_bigru"))}

    def counts(ks):
        return {name: k.launches for name, k in ks.items()}

    def moved(ks, before):
        return {n: ks[n].launches - before[n] for n in ks if ks[n].launches != before[n]}

    # (q1) ---------------------------------------------------------------
    t0 = time.perf_counter()
    hp = default_hparams(GE2E_Train={"Batch_Speakers": Q1_N, "Batch_Utterances": Q1_M,
                                     "Frame_Length": Q1_FRAMES},
                         Speaker_Embedding={"GE2E": {"LSTM": {"Sizes": Q1_H}}})
    trainer = GE2ETrainer(hp, checkpoint_dir=str(work / "q1_ge2e"), log_dir=str(work / "q1_logs"),
                          device="cuda", seed=0)
    mels = _p1_mels(hp, Q1_N * Q1_M, Q1_FRAMES, seed=1792)
    layers, B1 = hp.Speaker_Embedding.GE2E.LSTM.Stacks, Q1_N * Q1_M
    fwd_groups = {D: lstm_kernel.fwd_row_groups(1, D, Q1_H, B1, card) for D in (80, Q1_H)}
    bwd_groups = lstm_kernel.bwd_row_groups(1, Q1_H, B1, card)
    plan = {"fwd_rows": {D: g[0].stop for D, g in fwd_groups.items()},
            "fwd_layout": {D: lstm_kernel.fwd_layout(1, D, Q1_H, B1, g[0].stop, card)
                           for D, g in fwd_groups.items()},
            "bwd_rows": bwd_groups[0].stop,
            "bwd_layout": lstm_kernel.bwd_layout(1, Q1_H, B1, bwd_groups[0].stop, card)}
    fwd_calls, bwd_calls = [], []
    torch.cuda.synchronize()
    before = counts(objs)
    with _recorded((lstm_kernel, "lstm_seq_layer_kernel", fwd_calls, layers),
                   (lstm_kernel, "lstm_seq_layer_bwd_kernel", bwd_calls, layers)):
        m = trainer.train_step(mels)
    torch.cuda.synchronize()
    launched = moved(objs, before)
    want = {"ge2e_lstm_residuals": len(fwd_groups[80]) + (layers - 1) * len(fwd_groups[Q1_H]),
            "ge2e_lstm_bwd": layers * len(bwd_groups)}
    data["launches"]["ge2e_lstm_layer_residuals_wide"] = launched.get("ge2e_lstm_residuals", 0)
    data["launches"]["ge2e_lstm_bwd_wide"] = launched.get("ge2e_lstm_bwd", 0)
    print(f"[q1 ge2e] GE2ETrainer.train_step at N {Q1_N} x M {Q1_M} = {B1} rows, {Q1_FRAMES}-"
          f"frame crops, LSTM {Q1_H} x {layers}: loss {m['loss']:.6f}; plan {json.dumps(plan)}; "
          f"launches {launched}, want {want}; {time.perf_counter() - t0:.1f} s")
    if not all(math.isfinite(v) for v in m.values()):
        fails.append(f"[q1 ge2e] metrics {m}")
    if {n: launched.get(n, 0) for n in want} != want or not all(
            plan["fwd_layout"][D]["wide"] for D in (80, Q1_H)) or not plan["bwd_layout"]["wide"]:
        fails.append(f"[q1 ge2e] launches {launched}, want {want}; plan {plan}")
    dGs, grads = {"kernel": [], "plain": []}, {}
    for label, instead in (("kernel", None), ("plain", lstm_kernel.lstm_seq_layer_bwd_plain)):
        with _recorded((lstm_kernel, "lstm_seq_layer_bwd_kernel", dGs[label], layers, instead)):
            loss, g = trainer.gradients(mels)
        grads[label] = (float(loss), {k: v.float() for k, v in g.items()})
        dGs[label] = [out[:, :8].clone() for _, _, out in dGs[label]]
    torch.cuda.synchronize()
    (lk, gk), (lp, gp) = grads["kernel"], grads["plain"]
    norm_k = float(torch.sqrt(sum((v * v).sum() for v in gk.values())))
    norm_p = float(torch.sqrt(sum((v * v).sum() for v in gp.values())))
    dg8 = max(float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-12))
              for a, b in zip(dGs["kernel"], dGs["plain"]))
    data["q1"] = {"fwd": [a for a, _, _ in fwd_calls], "bwd": [a for a, _, _ in bwd_calls],
                  "loss": [lk, lp], "grad_norm": [norm_k, norm_p], "dG8": dg8, "plan": plan}
    print(f"[q1 ge2e] kernel vs plain reverse pass: loss {lk:.7f} / {lp:.7f}, grad norm "
          f"{norm_k:.6g} / {norm_p:.6g} (rel {abs(norm_k - norm_p) / max(norm_p, 1e-12):.2e}), "
          f"dG of the first 8 rows {dg8:.2e} of the peak")
    if (abs(lk - lp) > 1e-2 * max(1.0, abs(lp)) or abs(norm_k - norm_p) > 2e-2 * norm_p
            or dg8 > 1e-2 or len(dGs["kernel"]) != layers):
        fails.append(f"[q1 ge2e] kernel vs plain backward: loss {lk} / {lp}, norm {norm_k} / "
                     f"{norm_p}, dG8 {dg8}")
    del trainer, mels, grads, gk, gp, dGs
    print(f"[q1 ge2e] took {time.perf_counter() - t0:.1f} s")

    # (q2) ---------------------------------------------------------------
    t0 = time.perf_counter()
    hp_w = default_hparams(**Q2_HP)
    tr, state = _fresh_state(hp_w, work, "q2_wide", seed=2304)
    saved_logged = set(dsp._DISPATCH_LOGGED)
    dsp._DISPATCH_LOGGED.clear()  # any plain route prints its line again
    log = io.StringIO()
    synth = Synthesizer.from_state(hp_w, state, seed=0)
    emb = synth.enroll([str(p) for p in ENROLL])
    synth.synthesize(TEXTS[:1], emb, max_steps=8, early_exit=False, pcm16=True)  # warm-up
    torch.cuda.synchronize()
    before = counts(objs)
    enroll_calls, bi_calls = [], []
    with contextlib.redirect_stdout(log), _recorded(
            (lstm_kernel, "lstm_seq_layer_kernel", enroll_calls, 3),
            (birnn_kernel, "bilstm_recurrence_kernel", bi_calls, 1)):
        emb = synth.enroll([str(p) for p in ENROLL])
        out = synth.synthesize(TEXTS, emb, max_steps=Q2_STEPS, early_exit=False, pcm16=True,
                               split_vocode=False, return_device=True)
    torch.cuda.synchronize()
    launched = moved(objs, before)
    mel, wav = out["mel_post"], out["wav"]
    wav_ok = (wav.dtype == torch.int16 and bool(torch.isfinite(mel).all())
              and tuple(wav.shape) == (mel.shape[0], synth.dsp_cfg.hop * (mel.shape[1] - 1)))
    data["launches"]["ge2e_lstm_layer_wide"] = launched.get("ge2e_lstm", 0)
    data["launches"]["text_encoder_bilstm_wide"] = launched.get("bilstm", 0)
    H2 = hp_w.Encoder.LSTM_Size // 2
    print(f"[q2 wide] synthesize: encoder BiLSTM {H2} a direction, GE2E LSTM "
          f"{hp_w.Speaker_Embedding.GE2E.LSTM.Sizes}: {mel.shape[1]} frames, int16 wavs "
          f"{tuple(wav.shape)} {wav_ok}; launches {launched}")
    if not launched.get("ge2e_lstm") or not launched.get("bilstm") or not wav_ok:
        fails.append(f"[q2 wide] synthesize: launches {launched}, wavs {wav_ok}")
    del synth
    batch = _train_batch(hp_w, 8, seed=0)
    before = counts(objs)
    res_calls, bwd9_calls = [], []
    with contextlib.redirect_stdout(log), _recorded(
            (birnn_kernel, "bilstm_recurrence_kernel", res_calls, 1),
            (birnn_kernel, "bilstm_bwd_kernel", bwd9_calls, 1)):
        m = tr.train_step(batch)
    torch.cuda.synchronize()
    launched = moved(objs, before)
    for row, n in (("text_encoder_bilstm_residuals_wide", "bilstm_residuals"),
                   ("text_encoder_bilstm_bwd_wide", "bilstm_bwd")):
        data["launches"][row] = launched.get(n, 0)
    need = ("ge2e_lstm_residuals", "ge2e_lstm_bwd", "bilstm_residuals", "bilstm_bwd")
    print(f"[q2 wide] Trainer.train_step on 8 rows: total {m.get('total')}, launches {launched}")
    if any(not launched.get(n) for n in need) or m.get("skipped_nonfinite"):
        fails.append(f"[q2 wide] train step: launches {launched}, metrics {m}")
    plain_lines = [ln for ln in log.getvalue().splitlines() if "[dispatch]" in ln]
    print(f"[q2 wide] [dispatch] lines: {plain_lines}")
    if any("-> plain" in ln for ln in plain_lines):
        fails.append(f"[q2 wide] a plain route ran: {plain_lines}")
    data["q2"] = {"enroll": [a for a, _, _ in enroll_calls], "bilstm": [a for a, _, _ in bi_calls],
                  "bilstm_res": [a for a, _, _ in res_calls],
                  "bilstm_bwd": [a for a, _, _ in bwd9_calls]}
    del tr, state, batch
    print(f"[q2 wide] took {time.perf_counter() - t0:.1f} s")

    # (q3) ---------------------------------------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(1300)
    gl_kernels = {"griffin_lim_staged": griffin_lim_staged.KERNEL,
                  "griffin_lim_staged_momentum": griffin_lim_staged.MOM_KERNEL,
                  "griffin_lim_dense": griffin_lim_kernel.KERNEL}
    for n_fft, hop, T in Q3_GL:
        mag = torch.from_numpy(rng.random((1, T, n_fft // 2 + 1)).astype(np.float32)).cuda()
        dsp._DISPATCH_LOGGED.clear()
        log = io.StringIO()
        before = counts(gl_kernels)
        with contextlib.redirect_stdout(log):
            wav = stft_matmul.griffin_lim_auto(mag, n_fft, hop, 8, hop * (T - 1))
        torch.cuda.synchronize()
        lines = [ln for ln in log.getvalue().splitlines() if ln.startswith("[dispatch]")]
        ok = (lines == [ln for ln in lines if "griffin_lim -> gemm" in ln] and len(lines) == 1
              and not moved(gl_kernels, before) and bool(torch.isfinite(wav).all())
              and tuple(wav.shape) == (1, hop * (T - 1)))
        print(f"[q3 routes] griffin_lim_auto at n_fft {n_fft}, hop {hop}, T {T}, B 1: {lines}; "
              f"Griffin-Lim launches {moved(gl_kernels, before)}; wav {tuple(wav.shape)}")
        if not ok:
            fails.append(f"[q3 routes] Griffin-Lim at {n_fft} / {hop}, T {T}: {lines}")
    hp_r = default_hparams(**Q3_HP)
    tr, state = _fresh_state(hp_r, work, "q3_routes", seed=2176)
    synth = Synthesizer.from_state(hp_r, state, quantize="bf16_pallas", seed=0)
    emb = synth.enroll([str(p) for p in ENROLL[:1]])
    dsp._DISPATCH_LOGGED.clear()
    log = io.StringIO()
    before = counts(refused)
    with contextlib.redirect_stdout(log):
        out = synth.synthesize(TEXTS[:1], emb, max_steps=4, early_exit=False, vocode=False,
                               return_device=True)
    torch.cuda.synchronize()
    lines = [ln for ln in log.getvalue().splitlines() if ln.startswith("[dispatch]")]
    moved_r = moved(refused, before)
    want_lines = ("[dispatch] decode -> plain", "[dispatch] bigru -> plain")
    ok = (all(any(ln.startswith(w) for ln in lines) for w in want_lines) and not moved_r
          and bool(torch.isfinite(out["mel_post"]).all()))
    print(f"[q3 routes] synthesize under bf16_pallas at decoder LSTM "
          f"{hp_r.Decoder.LSTM.Sizes} and CBHG GRU_Size {hp_r.Linear_Head.CBHG.GRU_Size} "
          f"({hp_r.Linear_Head.CBHG.GRU_Size // 2} a direction): {lines}; decode and BiGRU "
          f"launches {moved_r}; mel {tuple(out['mel_post'].shape)}")
    if not ok:
        fails.append(f"[q3 routes] decode / BiGRU: {lines}, launches {moved_r}")
    dsp._DISPATCH_LOGGED.update(saved_logged)
    del tr, state, synth
    print(f"[q3 routes] took {time.perf_counter() - t0:.1f} s")
    return fails, data


# -- Pass (r): the last shapes the reference's gates launch, and data --------
# -- parallelism across hosts ------------------------------------------------

# (r1) a decoder LSTM of 3072 x 2 in int8 (U 24 units a gate block: six
# m-tiles in two passes); (r2) a CBHG BiGRU of 1280 a direction (the wide
# route's streamed build); (r3) the dense Griffin-Lim past n_fft 2048 at the
# JAX cap's largest T for one row; (r4) two ranks presenting two hosts.
R1_HP = {"Decoder": {"LSTM": {"Sizes": 3072}}}
R1_STEPS = 64  # frames: 32 decoder steps at r 2, two chunks of 16
R2_HP = {"Linear_Head": {"CBHG": {"GRU_Size": 2560}}}
R3_GL = [(4096, 512, 304), (16384, 2048, 79)]
R3_ITERS = 8


def reference_shapes_pass(kernels: dict, work: pathlib.Path) -> tuple[list, dict]:
    """Pass (r). (r1) a fresh ``Trainer`` at R1_HP (N(0, 0.02)) through
    ``Synthesizer.from_state`` under ``int8_pallas``: enroll, R1_STEPS
    fixed-length frames (32 decoder steps), twice: #6 launched on every chunk (one launch a row
    group), no plain decode step, no decode or plain ``[dispatch]`` line,
    every chunk and the output bit-equal on repeat. (r2) a fresh ``Trainer`` at R2_HP:
    synthesize under ``bf16_pallas`` (#5 on the wide route's streamed
    build), one train step of 8 rows (#5r, #10 there), and the step's
    gradients again with the plain reverse pass in place of #10 under the
    same dropout draws (loss 1e-2, gradient norm 2e-2, dG of the first 8
    rows 1e-2 of the peak: pass (p1)'s gates); no plain route. (r3) ``griffin_lim_auto`` at each of
    R3_GL, one row: the dense kernel launched once a chunk, its dense
    ``[dispatch]`` line and no GEMM line. (r4) two ranks of (k1)'s step,
    each presenting a host of its own (``LOCAL_RANK`` 0,
    ``LOCAL_WORLD_SIZE`` 1, gloo on the one card): step 1's losses within
    1e-4 of (k1)'s ranks' and its gradient norm within DP_NORM_TOL. Counts zeroed just before each and read just after.
    Returns the failures and what the kernel phase's rows of this pass
    read."""
    import io
    import tempfile

    import numpy as np
    import torch

    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.hparams import default_hparams
    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.ops import (
        birnn_kernel, decode_kernel, decoder_scan, griffin_lim_kernel, griffin_lim_staged,
        stft_matmul,
    )

    fails, data = [], {"launches": {}}
    card = decode_kernel.card_limits("cuda")

    def counts(ks):
        return {name: k.launches for name, k in ks.items()}

    def moved(ks, before):
        return {n: ks[n].launches - before[n] for n in ks if ks[n].launches != before[n]}

    saved_logged = set(dsp._DISPATCH_LOGGED)

    # (r1) ---------------------------------------------------------------
    t0 = time.perf_counter()
    hp1 = default_hparams(**R1_HP)
    tr, state = _fresh_state(hp1, work, "r1_int8", seed=3072)
    del tr
    synth = Synthesizer.from_state(hp1, state, quantize="int8_pallas", seed=0)
    del state
    emb = synth.enroll([str(p) for p in ENROLL])
    synth.synthesize(TEXTS[:1], emb, max_steps=16, early_exit=False, pcm16=True)  # packs
    torch.cuda.synchronize()
    dsp._DISPATCH_LOGGED.clear()
    log = io.StringIO()
    before = counts(kernels)
    dec, plain_steps, plain_segments = [], [], []
    with contextlib.redirect_stdout(log), _recorded(
            (decode_kernel, "decode_segment_kernel", dec, 1 << 30),
            (decoder_scan, "decoder_cell_step", plain_steps, 1 << 30),
            (decode_kernel, "decode_segment_plain", plain_segments, 1 << 30)):
        emb = synth.enroll([str(p) for p in ENROLL])
        runs = [synth.synthesize(TEXTS, emb, max_steps=R1_STEPS, early_exit=False, pcm16=True,
                                 split_vocode=False, return_device=True) for _ in range(2)]
    torch.cuda.synchronize()
    launched = moved(kernels, before)
    H1 = hp1.Decoder.LSTM.Sizes
    rows1, S1 = dec[0][0][1].shape[:2] if dec else (0, 0)
    groups1 = len(decode_kernel.kernel_row_groups(dec[0][0][0], rows1, S1, "cuda")) if dec else 0
    n = len(dec) // 2
    chunks_equal = n > 0 and len(dec) == 2 * n and all(
        torch.equal(x, y) for (_, _, a1), (_, _, a2) in zip(dec[:n], dec[n:])
        for x, y in zip(_tensors(a1), _tensors(a2)))
    out, again = runs
    outputs_equal = out.keys() == again.keys() and all(torch.equal(out[k], again[k]) for k in out)
    wav = out["wav"]
    wav_ok = wav.dtype == torch.int16 and bool(torch.isfinite(out["mel_post"]).all())
    lay = decode_kernel.decode_layout(H1, card[0])
    lines = [ln for ln in log.getvalue().splitlines() if ln.startswith("[dispatch] decode")
             or "-> plain" in ln]
    plain_ran = {"decoder_cell_step": len(plain_steps),
                 "decode_segment_plain": len(plain_segments)}
    data["launches"]["decode_segment_int8_past_2048"] = launched.get("decode_segment_int8", 0)
    data["r1"] = dec[0][0] if dec else None
    print(f"[r1 int8] decoder LSTM {H1} x 2, int8_pallas: {lay['U']} units a gate block, "
          f"{lay['mt']} m-tiles ({-(-lay['mt'] // decode_kernel.MAX_M_TILES)} passes); {n} "
          f"chunk(s) a run, {groups1} row group(s) a chunk; launches {launched}; bit-equal on "
          f"repeat: chunks {chunks_equal}, outputs {outputs_equal}; wavs {tuple(wav.shape)} "
          f"{wav_ok}; plain decode calls {plain_ran}; decode or plain [dispatch] lines {lines}; "
          f"{time.perf_counter() - t0:.1f} s")
    if (launched.get("decode_segment_int8") != 2 * n * groups1 or any(plain_ran.values())
            or lines or not chunks_equal or not outputs_equal or not wav_ok
            or lay["mt"] <= decode_kernel.MAX_M_TILES):
        fails.append(f"[r1 int8] launches {launched} ({n} chunks x {groups1} groups x 2 runs), "
                     f"plain {plain_ran}, lines {lines}, bit-equal {chunks_equal} / "
                     f"{outputs_equal}, wavs {wav_ok}")
    del synth, runs, out, again, dec
    torch.cuda.empty_cache()

    # (r2) ---------------------------------------------------------------
    t0 = time.perf_counter()
    hp2 = default_hparams(**R2_HP)
    tr, state = _fresh_state(hp2, work, "r2_bigru", seed=1280)
    H2 = hp2.Linear_Head.CBHG.GRU_Size // 2
    gru_objs = {k: kernels[k] for k in ("cbhg_bigru_wide", "cbhg_bigru_wide_residuals",
                                        "cbhg_bigru_wide_bwd", "cbhg_bigru", "cbhg_bigru_bwd",
                                        "cbhg_bigru_residuals")}
    synth = Synthesizer.from_state(hp2, state, quantize="bf16_pallas", seed=0)
    emb = synth.enroll([str(p) for p in ENROLL[:1]])
    synth.synthesize(TEXTS[:1], emb, max_steps=8, early_exit=False, pcm16=True)  # warm-up
    torch.cuda.synchronize()
    dsp._DISPATCH_LOGGED.clear()
    log = io.StringIO()
    before = counts(gru_objs)
    fwd_calls = []
    with contextlib.redirect_stdout(log), _recorded(
            (birnn_kernel, "bigru_recurrence_kernel", fwd_calls, 1)):
        out = synth.synthesize(TEXTS, emb, max_steps=16, early_exit=False, pcm16=True,
                               split_vocode=False, return_device=True)
    torch.cuda.synchronize()
    launched_s = moved(gru_objs, before)
    del synth
    batch = _train_batch(hp2, 8, seed=0)
    before = counts(gru_objs)
    res_calls, bwd_calls = [], []
    with contextlib.redirect_stdout(log), _recorded(
            (birnn_kernel, "bigru_recurrence_kernel", res_calls, 1 << 30),
            (birnn_kernel, "bigru_bwd_kernel", bwd_calls, 1)):
        m = tr.train_step(batch)
    torch.cuda.synchronize()
    launched_t = moved(gru_objs, before)
    # The same dropout draws for both: the trainer's generator from one state.
    dGs, grads = {"kernel": [], "plain": []}, {}
    gen_state = tr.generator.get_state()
    for label, instead in (("kernel", None), ("plain", birnn_kernel.bigru_bwd_plain)):
        tr.generator.set_state(gen_state)
        with contextlib.redirect_stdout(log), _recorded(
                (birnn_kernel, "bigru_bwd_kernel", dGs[label], 1, instead)):
            losses, g = tr.gradients(batch)
        grads[label] = (losses["total"], g)
        dGs[label] = [o[:, :8].float().clone() for o in dGs[label][0][2]] if dGs[label] else []
    torch.cuda.synchronize()
    (lk, gk_), (lp, gp_) = grads["kernel"], grads["plain"]
    norm_k = float(np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in gk_.values())))
    norm_p = float(np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in gp_.values())))
    dg8 = max((float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))
               for a, b in zip(dGs["kernel"], dGs["plain"])), default=float("inf"))
    lay_f = birnn_kernel.wide_layout(False, H2, 8, card)
    lay_b = birnn_kernel.wide_layout(True, H2, 8, card)
    lines = [ln for ln in log.getvalue().splitlines() if ln.startswith("[dispatch]")]
    for row, name in (("cbhg_bigru_streamed", "cbhg_bigru_wide"),
                      ("cbhg_bigru_streamed_residuals", "cbhg_bigru_wide_residuals"),
                      ("cbhg_bigru_streamed_bwd", "cbhg_bigru_wide_bwd")):
        data["launches"][row] = launched_s.get(name, 0) + launched_t.get(name, 0)
    data["r2"] = {"fwd": [a for a, _, _ in fwd_calls],
                  "res": [a for a, _, _ in res_calls if len(a) > 4 and a[4]][:1],
                  "bwd": [a for a, _, _ in bwd_calls], "loss": [lk, lp],
                  "grad_norm": [norm_k, norm_p], "dG8": dg8,
                  "layout": {"fwd": lay_f, "bwd": lay_b}}
    print(f"[r2 bigru] CBHG GRU_Size {2 * H2} ({H2} a direction): synthesize launches "
          f"{launched_s}, train step launches {launched_t} (total {m.get('total')}); layouts "
          f"at 8 rows: forward {json.dumps(lay_f)}, backward {json.dumps(lay_b)}; kernel vs "
          f"plain reverse pass: loss {lk:.7f} / {lp:.7f}, grad norm {norm_k:.6g} / {norm_p:.6g} "
          f"(rel {abs(norm_k - norm_p) / max(norm_p, 1e-12):.2e}), dG of the first 8 rows "
          f"{dg8:.2e} of the peak; [dispatch] lines {lines}; {time.perf_counter() - t0:.1f} s")
    if (not launched_s.get("cbhg_bigru_wide") or not launched_t.get("cbhg_bigru_wide_residuals")
            or not launched_t.get("cbhg_bigru_wide_bwd")
            or any(k in launched_s or k in launched_t
                   for k in ("cbhg_bigru", "cbhg_bigru_bwd", "cbhg_bigru_residuals"))
            or not lay_f["stream"] or not lay_b["stream"] or lay_f["ntr"] >= lay_f["nt"]
            or any("-> plain" in ln for ln in lines) or m.get("skipped_nonfinite")
            or not bool(torch.isfinite(out["mel_post"]).all())):
        fails.append(f"[r2 bigru] launches {launched_s} / {launched_t}, layouts {lay_f} / "
                     f"{lay_b}, lines {lines}, metrics {m}")
    if (abs(lk - lp) > 1e-2 * max(1.0, abs(lp)) or abs(norm_k - norm_p) > 2e-2 * norm_p
            or dg8 > 1e-2):
        fails.append(f"[r2 bigru] kernel vs plain backward: loss {lk} / {lp}, norm {norm_k} / "
                     f"{norm_p}, dG8 {dg8}")
    del tr, state, batch, grads, gk_, gp_, out
    torch.cuda.empty_cache()

    # (r3) ---------------------------------------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(4096)
    gl_objs = {"griffin_lim_staged": griffin_lim_staged.KERNEL,
               "griffin_lim_staged_momentum": griffin_lim_staged.MOM_KERNEL,
               "griffin_lim_dense": griffin_lim_kernel.KERNEL}
    data["r3"], data["launches"]["griffin_lim_dense_wide"] = [], 0
    for n_fft, hop, T in R3_GL:
        mag = torch.from_numpy((rng.random((1, T, n_fft // 2 + 1)) ** 2)
                               .astype(np.float32)).cuda()
        dsp._DISPATCH_LOGGED.clear()
        log = io.StringIO()
        dense_calls = []
        before = counts(gl_objs)
        with contextlib.redirect_stdout(log), _recorded(
                (griffin_lim_kernel, "griffin_lim_dense_kernel", dense_calls, 1 << 30)):
            wav = stft_matmul.griffin_lim_auto(mag, n_fft, hop, R3_ITERS, hop * (T - 1))
        torch.cuda.synchronize()
        lines = [ln for ln in log.getvalue().splitlines() if ln.startswith("[dispatch]")]
        launched = moved(gl_objs, before)
        chunks = -(-1 // stft_matmul.gl_max_batch(T, n_fft, 0.0, "dense"))
        ok = (launched == {"griffin_lim_dense": chunks} and len(lines) == 1
              and lines[0].startswith("[dispatch] griffin_lim -> dense")
              and bool(torch.isfinite(wav).all()) and tuple(wav.shape) == (1, hop * (T - 1)))
        plan = griffin_lim_kernel.kernel_plan(1, T, n_fft, hop)
        data["launches"]["griffin_lim_dense_wide"] += launched.get("griffin_lim_dense", 0)
        data["r3"].append(dense_calls[0][0] if dense_calls else None)
        print(f"[r3 griffin-lim] griffin_lim_auto at n_fft {n_fft}, hop {hop}, T {T}, B 1, "
              f"{R3_ITERS} iterations: {lines}; launches {launched}; plan {json.dumps(plan)}; "
              f"wav {tuple(wav.shape)}")
        if not ok:
            fails.append(f"[r3 griffin-lim] {n_fft} / {hop}, T {T}: {lines}, launches {launched}")
    print(f"[r3 griffin-lim] took {time.perf_counter() - t0:.1f} s")

    # (r4) ---------------------------------------------------------------
    t0 = time.perf_counter()
    env = {"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}
    with tempfile.TemporaryDirectory() as tmp:
        codes = _spawn_ranks(DP_WORLD, "gloo", tmp, 1, env)
        ranks = ([json.loads(pathlib.Path(f"{tmp}/rank{r}.json").read_text())
                  for r in range(DP_WORLD)] if codes == [0] * DP_WORLD else [])
    got = [r["steps"][0]["metrics"] for r in ranks]
    want = K1_STEP1.get("metrics") or []
    # The same step as (k1)'s in another pair of processes: the card's
    # kernels choices may differ between processes (H100 runs read the step
    # bit-equal twice and once 4e-7 apart in a loss, 3.5e-4 in the gradient
    # norm). Each loss within 1e-4 of (k1)'s, the gradient norm within (k1)'s
    # own gate against the single-process step (DP_NORM_TOL); bit-equality
    # printed.
    loss_rel = max((abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for g, w in zip(got, want)
                    for k in w if k not in ("grad_norm", "skipped_nonfinite")),
                   default=float("inf")) if len(got) == len(want) else float("inf")
    norm_rel = max((abs(g["grad_norm"] - w["grad_norm"]) / max(abs(w["grad_norm"]), 1e-12)
                    for g, w in zip(got, want)), default=float("inf"))
    print(f"[r4 two hosts] {DP_WORLD} ranks, each a host of its own (LOCAL_RANK 0, "
          f"LOCAL_WORLD_SIZE 1, gloo): exit codes {codes}; devices "
          f"{[r['device'] for r in ranks]}, local {[r['local'] for r in ranks]}; step 1 "
          f"{json.dumps(got[0] if got else None)}; against (k1)'s ranks' step 1: largest "
          f"relative loss difference {loss_rel:.2e} (tolerance 1e-4), grad norm {norm_rel:.2e} "
          f"(tolerance {DP_NORM_TOL}), metrics bit-equal {got == want}; "
          f"{time.perf_counter() - t0:.1f} s")
    if codes != [0] * DP_WORLD or loss_rel > 1e-4 or norm_rel > DP_NORM_TOL or any(
            r["local"] != [0, 1] or r["world"] != DP_WORLD for r in ranks):
        fails.append(f"[r4 two hosts] exit codes {codes}, step 1 {got} vs (k1) {want}")
    dsp._DISPATCH_LOGGED.update(saved_logged)
    return fails, data


# -- Pass (s): the HiFi-GAN generator's MRF kernels ----------------------------
# The synth_hifigan.b32-short cell's largest bucket: rows x decoder frames.
HIFIGAN_ROWS, HIFIGAN_FRAMES = 32, 400
# Row #12's gate: the MRF's mean against the same launches through the
# plain convolution, max |gap| / max |plain| at each stage. The kernel read
# 0.92-1.03e-3 on an H100 (its f32 sums in another order tip a few bf16
# roundings of the intermediates); one launch's bias dropped, a tap zeroed,
# its dilation off by one or its residual left out read 0.066-0.35.
HIFIGAN_MRF_TOL = 3e-3


def _hifigan_weights(gen, seed: int) -> dict:
    """Seeded folded f32 weights for every module of ``gen``
    (``tests/reference_hifigan.py``'s draw): biases uniform in +-1/16,
    weights normal over the root of their fan-in."""
    import torch

    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in gen.state_dict().items():
        if name.endswith(".bias"):
            out[name] = ((torch.rand(p.shape, generator=g) * 2 - 1) / 16.0).numpy()
        else:
            fan_in = p.shape[0] * p.shape[2] if name.startswith("ups.") else p.shape[1] * p.shape[2]
            out[name] = (torch.randn(p.shape, generator=g) / fan_in ** 0.5).numpy()
    return out


def hifigan_pass(params, batch_stats, hp, wavs) -> tuple[list, dict]:
    """Pass (s). (s1) the checkpoint with ``Vocoder.Type: HiFiGAN`` (V1,
    seeded weights, bf16, ``bf16_pallas``, mel-only head) synthesizes the
    four texts, warmed up, then again with the launch counts zeroed just
    before and a profiler recording the program's counts: every generator
    call must launch the MRF kernel 72 times (4 stages x 3 blocks x 3
    dilations x 2) and the pointwise kernel 13 times (each stage's input
    activation, ``mrf_in``, the MRF's activation; post's), count rows x 36
    ``vocode.mrf_kernel_steps``, print no ``[dispatch] hifigan_mrf`` line,
    and give finite int16 wavs. (s2) the same generator on a seeded mel of
    HIFIGAN_ROWS x HIFIGAN_FRAMES: each stage's MRF input kept for row #12,
    ``mrf_in`` and the activation pass bit-equal to their plain forms at
    each stage's shape. Returns the failures and what row #12 reads."""
    import numpy as np
    import torch

    from multi_speaker_tts_tpu_torch import telemetry
    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.models import hifigan
    from multi_speaker_tts_tpu_torch.ops import hifigan_mrf
    from torch.profiler import ProfilerActivity, profile

    fails, t0 = [], time.perf_counter()
    hp_h = hp.replace(Linear_Head={"Use": False},
                      Vocoder={"Type": "HiFiGAN", "HiFiGAN": hifigan.V1})
    W = _hifigan_weights(hifigan.HiFiGAN.from_hp(hp_h), 23)
    synth = Synthesizer(hp_h, params, batch_stats, seed=0, device="cuda",
                        quantize="bf16_pallas", vocoder_params=W)
    gen = synth.vocoder
    emb = synth.enroll(wavs)
    synth.synthesize(TEXTS, emb, pcm16=True)
    calls = []
    forward = gen.forward

    def counted(mel):
        calls.append(mel.shape[0])
        return forward(mel)

    gen.forward = counted
    hifigan_mrf.KERNEL.launches = hifigan_mrf.IN_KERNEL.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]):
        lo = time.time_ns()
        out = synth.synthesize(TEXTS, emb, pcm16=True)
        torch.cuda.synchronize()
        hi = time.time_ns()
    del gen.forward
    steps = sum(n for _, n in telemetry.events("vocode.mrf_kernel_steps", lo, hi) or [])
    launches = {"conv": hifigan_mrf.KERNEL.launches, "pointwise": hifigan_mrf.IN_KERNEL.launches}
    wav_ok = all(o["wav"].dtype == np.int16 and o["wav"].size > 0
                 and np.abs(o["wav"].astype(np.int64)).max() > 0 for o in out)
    plain = [k for k in dsp._DISPATCH_LOGGED if k[0] == "hifigan_mrf"]
    print(f"[s1 hifigan] {len(TEXTS)} texts, generator calls of {calls} rows, compute dtype "
          f"{gen.compute_dtype}: launches {launches} (72 and 13 a call), "
          f"vocode.mrf_kernel_steps {steps} (36 a row), plain routes {plain}, wavs int16 "
          f"and audible {wav_ok}")
    if (gen.compute_dtype != torch.bfloat16 or not calls or plain or not wav_ok
            or launches != {"conv": 72 * len(calls), "pointwise": 13 * len(calls)}
            or steps != 36 * sum(calls)):
        fails.append(f"[s1 hifigan] calls {calls}, launches {launches}, steps {steps}, plain "
                     f"routes {plain}, wavs {wav_ok}")
    del synth, out

    # (s2) the cell's largest bucket, stage by stage.
    mel = torch.rand((HIFIGAN_ROWS, HIFIGAN_FRAMES, hp.Sound.Mel_Dim),
                     generator=torch.Generator().manual_seed(5)).cuda()
    n = gen.n_kernels
    stages, exact = [], []
    with torch.no_grad():
        x = gen.pre(mel)
        for i in range(len(gen.ups)):
            u, k = gen.rates[i], gen.kernel_sizes[i]
            a = hifigan._activation(x, hifigan.SLOPE, torch.bfloat16)
            y = hifigan._conv_cl(a, gen.ups[i].weight, transposed=True, stride=u,
                                 padding=(k - u) // 2)
            xs = hifigan_mrf.mrf_in(y, gen.ups[i].bias)
            exact.append(torch.equal(xs, y.float() + gen.ups[i].bias.float()))
            exact.append(torch.equal(hifigan_mrf.activation(xs, hifigan.SLOPE),
                                     torch.nn.functional.leaky_relu(xs, hifigan.SLOPE)
                                     .to(torch.bfloat16)))
            stages.append({"blocks": gen.resblocks[i * n:(i + 1) * n], "x": xs})
            x = gen.stage(i, x)
            del a, y
        torch.cuda.synchronize()
    shapes = [list(s["x"].shape) for s in stages]
    print(f"[s2 hifigan] MRF inputs {shapes}: mrf_in and the activation pass bit-equal to "
          f"their plain forms at each: {exact}; {time.perf_counter() - t0:.1f} s")
    if not all(exact):
        fails.append(f"[s2 hifigan] mrf_in / activation not bit-equal: {exact} at {shapes}")
    return fails, {"gen": gen, "mel": mel, "stages": stages, "launches": launches,
                   "calls": calls}


def main() -> int:
    import numpy as np

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
    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.ops import (
        _build, attention_step_kernel, birnn_kernel, decode_kernel, decoder_scan,
        griffin_lim_kernel, griffin_lim_staged, hifigan_mrf, lstm_kernel, mel_kernel,
        recurrence_floor, stft_matmul,
    )
    from multi_speaker_tts_tpu_torch.tools import attention_probe

    kernels = {
        "mel_frontend": mel_kernel.KERNEL,
        # Its DFT route (an n_fft that is not a power of two): the new mel
        # rows of the kernel phase.
        "mel_frontend_dft": mel_kernel.DFT_KERNEL,
        "ge2e_lstm_layer": lstm_kernel.KERNEL,
        "text_encoder_bilstm": birnn_kernel.KERNEL,
        "cbhg_bigru": birnn_kernel.GRU_KERNEL,
        "griffin_lim_staged": griffin_lim_staged.KERNEL,
        "griffin_lim_staged_momentum": griffin_lim_staged.MOM_KERNEL,
        "griffin_lim_dense": griffin_lim_kernel.KERNEL,
        "decode_segment_bf16": decode_kernel.KERNELS["bf16"],
        "decode_segment_int8": decode_kernel.KERNELS["int8"],
        # The train phase's: the residual modes of the three recurrences and
        # their backward kernels.
        "ge2e_lstm_layer_residuals": lstm_kernel.RES_KERNEL,
        "ge2e_lstm_bwd": lstm_kernel.BWD_KERNEL,
        "text_encoder_bilstm_residuals": birnn_kernel.RES_KERNEL,
        "text_encoder_bilstm_bwd": birnn_kernel.BWD_KERNEL,
        "cbhg_bigru_residuals": birnn_kernel.GRU_RES_KERNEL,
        "cbhg_bigru_bwd": birnn_kernel.GRU_BWD_KERNEL,
        # The attention-step probe's (h).
        "attention_step": attention_step_kernel.KERNEL,
        # Pass (p)'s routes past the production widths: the BiGRU past H 192
        # (all three modes) and the mel front-end's global-memory modes.
        "cbhg_bigru_wide": birnn_kernel.WIDE_GRU_KERNEL,
        "cbhg_bigru_wide_residuals": birnn_kernel.WIDE_GRU_RES_KERNEL,
        "cbhg_bigru_wide_bwd": birnn_kernel.WIDE_GRU_BWD_KERNEL,
        "mel_frontend_global": mel_kernel.FFT_GLOBAL_KERNEL,
        "mel_frontend_dft_global": mel_kernel.DFT_GLOBAL_KERNEL,
    }

    # 1. Build ---------------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build([*dict.fromkeys(k.source for k in kernels.values()),
                            recurrence_floor.KERNEL.source, hifigan_mrf.KERNEL.source])
    t_build = time.perf_counter()
    print(f"build: {len(reports)} sources compiled in {t_build - t0:.1f} s")
    # Registers and spills of each source's kernels, as -Xptxas -v reports them.
    ptxas = {src: {"registers": [], "spill_bytes": 0} for src in reports}
    for src, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")
            if "Used" in line and "registers" in line:
                ptxas[src]["registers"].append(int(line.split("Used")[1].split()[0]))
            if "spill stores" in line:
                ptxas[src]["spill_bytes"] += int(line.split("bytes spill stores")[0].split(",")[-1])

    # 2. Main path -----------------------------------------------------------
    params, batch_stats, meta = load_compact(CKPT)
    hp = Recursive_Parse(meta["hp"])  # the checkpoint as it is: CBHG head on
    wavs = [wav_io.load_wav(p, target_sr=hp.Sound.Sample_Rate)[0] for p in ENROLL]

    recorded = {name: [] for name in (*kernels, "segment", "early_exit", "gl_auto", "mel_wav")}
    _record(mel_kernel, "melspectrogram_kernel", recorded["mel_frontend"])
    _record(mel_kernel, "melspectrogram_fused", recorded["mel_wav"])  # its clip, unpadded
    _record(lstm_kernel, "lstm_seq_layer_kernel", recorded["ge2e_lstm_layer"])
    _record(birnn_kernel, "bilstm_recurrence_kernel", recorded["text_encoder_bilstm"])
    _record(birnn_kernel, "bigru_recurrence_kernel", recorded["cbhg_bigru"])
    # One wrapper serves both modes of the staged kernel.
    _record(griffin_lim_staged, "griffin_lim_staged_kernel", recorded["griffin_lim_staged"])
    recorded["griffin_lim_staged_momentum"] = recorded["griffin_lim_staged"]
    _record(griffin_lim_kernel, "griffin_lim_dense_kernel", recorded["griffin_lim_dense"])
    _record(stft_matmul, "griffin_lim_auto", recorded["gl_auto"])
    # One wrapper serves both decode modes; a pass runs one of them.
    _record(decode_kernel, "decode_segment_kernel", recorded["decode_segment_bf16"])
    recorded["decode_segment_int8"] = recorded["decode_segment_bf16"]
    _record(decode_kernel, "decoder_ar_segment_kernel", recorded["segment"])
    _record(decoder_scan, "decoder_ar_early_exit", recorded["early_exit"])
    # The plain decode: steps of the Python loop, and the kernel's plain version.
    plain_calls = {"decoder_cell_step": [], "decode_segment_plain": []}
    _record(decoder_scan, "decoder_cell_step", plain_calls["decoder_cell_step"])
    _record(decode_kernel, "decode_segment_plain", plain_calls["decode_segment_plain"])
    # The train phase: the backward wrappers, and the plain backwards, which
    # must not run on the card. The forward wrappers above serve both modes
    # (``save_residuals`` among their arguments).
    _record(lstm_kernel, "lstm_seq_layer_bwd_kernel", recorded["ge2e_lstm_bwd"])
    _record(birnn_kernel, "bilstm_bwd_kernel", recorded["text_encoder_bilstm_bwd"])
    _record(birnn_kernel, "bigru_bwd_kernel", recorded["cbhg_bigru_bwd"])
    plain_bwd = {name: [] for name in ("lstm_seq_layer_bwd_plain", "bilstm_bwd_plain",
                                       "bigru_bwd_plain")}
    _record(lstm_kernel, "lstm_seq_layer_bwd_plain", plain_bwd["lstm_seq_layer_bwd_plain"])
    _record(birnn_kernel, "bilstm_bwd_plain", plain_bwd["bilstm_bwd_plain"])
    _record(birnn_kernel, "bigru_bwd_plain", plain_bwd["bigru_bwd_plain"])

    failures = []

    def run_pass(label: str, synth, texts, emb=None, **kw):
        """Warm up at the pass's shapes (loads the libraries, packs the
        weights, picks the cuBLAS kernels, grows the allocator's pool), then
        the counted pass: counts and records zeroed just before, read just
        after."""
        synth.synthesize(texts, synth.enroll(wavs) if emb is None else emb, pcm16=True, **kw)
        for store in (*recorded.values(), *plain_calls.values()):
            store.clear()
        for k in kernels.values():
            k.launches = 0
        # The earlier phases' garbage goes now, not inside the timed call:
        # the profiler's event graphs are reference cycles of ~10^5 objects,
        # whose gen-2 collection took 0.19 s inside pass (e) once (H100).
        gc.collect()
        torch.cuda.synchronize()
        with _GcPauses() as gc_pauses:
            t0 = time.perf_counter()
            t_enroll = 0.0
            if emb is None:
                emb = synth.enroll(wavs)
                torch.cuda.synchronize()
                t_enroll = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = synth.synthesize(texts, emb, pcm16=True, **kw)
            torch.cuda.synchronize()
            t_synth = time.perf_counter() - t0
        res = {
            "label": label, "emb": emb, "out": out, "t_enroll": t_enroll, "t_synth": t_synth,
            "launches": {name: k.launches for name, k in kernels.items()},
            "plain_steps": {name: len(store) for name, store in plain_calls.items()},
            "recorded": {name: list(store) for name, store in recorded.items()},
            "mel_lengths": [item["mel_length"] for item in out],
            "bucket": synth.last_decode_bucket,
        }
        audio_s = 0.0
        for i, item in enumerate(out):
            wav = item["wav"]
            if wav.dtype.name != "int16" or wav.ndim != 1 or wav.size == 0:
                failures.append(f"[{label}] utterance {i}: wav {wav.dtype} {wav.shape}")
            if item["mel_length"] <= 0:
                failures.append(f"[{label}] utterance {i}: mel_length {item['mel_length']}")
            if not (abs(wav.astype("int64")).max() > 0):
                failures.append(f"[{label}] utterance {i}: silent wav")
            audio_s += wav.size / hp.Sound.Sample_Rate
        print(f"[{label}] launches {res['launches']}; plain decode calls {res['plain_steps']}")
        print(f"[{label}] enroll: {len(wavs)} wavs in {t_enroll * 1e3:.1f} ms; synthesize: "
              f"{len(texts)} texts, mel_lengths {res['mel_lengths']}, decode bucket "
              f"{res['bucket']}, {audio_s:.2f} s of audio in {t_synth * 1e3:.1f} ms = "
              f"{audio_s / t_synth:.2f}x real time; garbage-collector pauses (generation, "
              f"ms): {gc_pauses.pauses}")
        return res

    def profile_pass(res, synth):
        """The same enroll + synthesize again (same dropout draws) under the
        profiler; the idle share of the unprofiled pass is its wall time
        less this device busy time."""
        busy_ms, out = _profile(res["label"], lambda: synth.synthesize(
            TEXTS, synth.enroll(wavs), pcm16=True))
        lengths = [item["mel_length"] for item in out]
        wall_ms = (res["t_enroll"] + res["t_synth"]) * 1e3
        print(f"[{res['label']}] device idle, unprofiled pass: busy {busy_ms:.1f} ms (profiled "
              f"repeat, mel_lengths {lengths}) of {wall_ms:.1f} ms wall = "
              f"{100 * (1 - busy_ms / wall_ms):.1f}% idle")
        if lengths != res["mel_lengths"]:
            failures.append(f"[{res['label']}] the same request decoded {lengths}, then "
                            f"{res['mel_lengths']}")
        else:
            diff = max(float(np.abs(a["mel"] - b["mel"]).max()) for a, b in zip(out, res["out"]))
            print(f"[{res['label']}] the same request again: equal mel lengths, mels "
                  f"{diff:.3e} apart")

    always = ("mel_frontend", "ge2e_lstm_layer", "text_encoder_bilstm", "cbhg_bigru",
              "griffin_lim_staged")
    passes = {}
    for label, quantize, decode in (("a default", None, None),
                                    ("b bf16_pallas", "bf16_pallas", "decode_segment_bf16"),
                                    ("c int8_pallas", "int8_pallas", "decode_segment_int8")):
        synth = Synthesizer(hp, params, batch_stats, seed=0, quantize=quantize)  # -> cuda
        res = passes[label[0]] = run_pass(label, synth, TEXTS)
        for name in (*always, *([decode] if decode else [])):
            if res["launches"][name] == 0:
                failures.append(f"[{label}] kernel {name} was not launched on the main path")
        if decode is None:
            if res["plain_steps"]["decoder_cell_step"] == 0:
                failures.append(f"[{label}] the default decode ran no plain step")
        else:
            # One launch a row group of at most 16 rows a chunk.
            chunks = len(res["recorded"]["segment"])
            groups = sum(len(decode_kernel.kernel_row_groups(a[0], *a[1].shape[:2], a[1].device))
                         for a, _, _ in res["recorded"]["segment"])
            if res["launches"][decode] != groups:
                failures.append(f"[{label}] {res['launches'][decode]} decode launches for "
                                f"{chunks} chunks of {groups} row groups")
            if any(res["plain_steps"].values()):
                failures.append(f"[{label}] the plain decode ran under a kernel mode: "
                                f"{res['plain_steps']}")
        if "linear" not in res["out"][0]:
            failures.append(f"[{label}] no linear spectrogram from the CBHG head")
        profile_pass(res, synth)
        if label[0] == "a":
            busy_ms, _ = _profile("a enroll", lambda: synth.enroll(wavs))
            print(f"[a enroll] device busy {busy_ms:.3f} ms (profiled enrollment of the "
                  f"{len(wavs)} wavs)")
        del synth
    pa, pb, pc = passes["a"], passes["b"], passes["c"]
    emb = pa["emb"]

    # The same enrollment through the port's plain path on the CPU.
    emb_cpu = Synthesizer(hp, params, batch_stats, device="cpu").enroll(wavs)
    cos = float((emb * emb_cpu).sum())
    print(f"enroll embedding: card vs plain CPU cosine {cos:.6f}")
    if not math.isfinite(cos) or cos < 0.999:
        failures.append(f"card embedding disagrees with the plain CPU path: cos {cos}")

    # Whole-utterance agreement under one seed. (a) and (b) both compute bf16
    # gates (in another summation order, through 50 steps of feedback with
    # dropout): lengths may move, by at most one chunk.
    def frames_of(res):
        return res["recorded"]["early_exit"][0][2][0]  # (n_steps, B, mel * r)

    K_main = decoder_scan.chunk_size(pa["bucket"] // int(hp.Decoder.N_Frames_Per_Step),
                                     int(hp.Decoder.get("Early_Exit_Chunk", 16)))
    r = int(hp.Decoder.N_Frames_Per_Step)
    n_ab = min(min(pa["mel_lengths"]), min(pb["mel_lengths"])) // r
    err_ab = (frames_of(pa)[:n_ab] - frames_of(pb)[:n_ab]).abs().max().item()
    err_ab_first = (frames_of(pa)[:K_main] - frames_of(pb)[:K_main]).abs().max().item()
    print(f"(a) default vs (b) bf16_pallas: mel_lengths {pa['mel_lengths']} vs "
          f"{pb['mel_lengths']}; decoder frames max abs {err_ab_first:.3e} over the first "
          f"chunk ({K_main} steps), {err_ab:.3e} over the first {n_ab} steps")
    if any(abs(x - y) > K_main * r for x, y in zip(pa["mel_lengths"], pb["mel_lengths"])):
        failures.append("(a) vs (b): mel lengths differ by more than one chunk")
    # (c) against the port's plain weight-only int8 decode (exact integer
    # sums on both sides, so only the f32 parts differ).
    synth = Synthesizer(hp, params, batch_stats, seed=0, quantize="int8")
    pd = run_pass("d int8 plain", synth, TEXTS, emb=emb)
    del synth
    err_cd = (frames_of(pc)[:K_main] - frames_of(pd)[:K_main]).abs().max().item()
    print(f"(c) int8_pallas vs (d) plain int8: mel_lengths {pc['mel_lengths']} vs "
          f"{pd['mel_lengths']}; decoder frames of the first chunk max abs {err_cd:.3e} "
          "(tolerance 1.0e-02)")
    if pc["mel_lengths"] != pd["mel_lengths"]:
        failures.append("(c) vs plain int8: mel lengths differ")
    if not err_cd <= 1e-2:
        failures.append(f"(c) vs plain int8: first-chunk frames differ by {err_cd}")

    # The mel-only configuration: no head, the filterbank pseudo-inverse.
    synth = Synthesizer(hp.replace(Linear_Head={"Use": False}), params, batch_stats, seed=0)
    pm = run_pass("mel-only", synth, TEXTS[:1], emb=emb)
    del synth
    if "linear" in pm["out"][0] or pm["launches"]["cbhg_bigru"]:
        failures.append("[mel-only] the linear head ran")
    for name in ("text_encoder_bilstm", "griffin_lim_staged"):
        if pm["launches"][name] == 0:
            failures.append(f"[mel-only] kernel {name} was not launched")

    # The fixed-length decode under the kernel modes: every step of the
    # bucket goes through the kernel, none through the plain loop.
    for quantize, decode in (("bf16_pallas", "decode_segment_bf16"),
                             ("int8_pallas", "decode_segment_int8")):
        synth = Synthesizer(hp, params, batch_stats, seed=0, quantize=quantize)
        pf = run_pass(f"fixed-length {quantize}", synth, TEXTS[:1], emb=emb, early_exit=False)
        del synth
        steps = pf["bucket"] // r
        want = (steps // decoder_scan.chunk_size(steps, int(hp.Decoder.get("Early_Exit_Chunk", 16)))
                * len(decode_kernel.row_groups(1)))  # chunks x row groups of the one-row batch
        if pf["launches"][decode] != want:
            failures.append(f"[fixed-length {quantize}] {pf['launches'][decode]} decode "
                            f"launches for {want} chunks")
        if any(pf["plain_steps"].values()):
            failures.append(f"[fixed-length {quantize}] the plain decode ran: "
                            f"{pf['plain_steps']}")

    # Vocoder passes. (e): momentum Griffin-Lim, the staged kernel's momentum
    # mode. (f): the dense kernel (GL_DENSE_KERNEL set inside this block and
    # restored), plain and with momentum. Spectral convergence of each pass's
    # Griffin-Lim output: || |STFT(y)| - target || / || target || over the
    # vocoded frames, the target being the magnitude the vocoder was given.
    def sc_of(wav, mag, n_fft, hop):
        rec = dsp.stft(wav, n_fft, hop).abs()[..., :mag.shape[-2], :]
        return (torch.linalg.vector_norm(rec - mag) / torch.linalg.vector_norm(mag)).item()

    def convergence(res):
        (mag, n_fft, hop, *_), _, wav = res["recorded"]["gl_auto"][0]
        return sc_of(wav, mag, n_fft, hop)

    hp_mom = hp.replace(Sound={"Griffin_Lim_Momentum": 0.99})
    synth = Synthesizer(hp_mom, params, batch_stats, seed=0)
    pe = run_pass("e momentum", synth, TEXTS, emb=emb)
    del synth
    if pe["launches"]["griffin_lim_staged_momentum"] == 0 or pe["launches"]["griffin_lim_staged"]:
        failures.append(f"[e momentum] staged launches {pe['launches']['griffin_lim_staged']} "
                        f"plain / {pe['launches']['griffin_lim_staged_momentum']} momentum")
    dense_passes = {}
    saved_env = os.environ.get("GL_DENSE_KERNEL")
    os.environ["GL_DENSE_KERNEL"] = "1"
    try:
        for label, hp_f in (("f dense", hp), ("f dense momentum", hp_mom)):
            synth = Synthesizer(hp_f, params, batch_stats, seed=0)
            res = dense_passes[label] = run_pass(label, synth, TEXTS, emb=emb)
            del synth
            staged_n = (res["launches"]["griffin_lim_staged"]
                        + res["launches"]["griffin_lim_staged_momentum"])
            if res["launches"]["griffin_lim_dense"] == 0 or staged_n:
                failures.append(f"[{label}] dense launches {res['launches']['griffin_lim_dense']}, "
                                f"staged launches {staged_n}")
    finally:
        if saved_env is None:
            os.environ.pop("GL_DENSE_KERNEL", None)
        else:
            os.environ["GL_DENSE_KERNEL"] = saved_env
    pf_plain, pf_mom = dense_passes["f dense"], dense_passes["f dense momentum"]
    sc = {"a staged": convergence(pa), "e staged momentum": convergence(pe),
          "f dense": convergence(pf_plain), "f dense momentum": convergence(pf_mom)}
    gap = abs(sc["f dense"] - sc["a staged"]) / sc["a staged"]
    print(f"spectral convergence at {hp.Sound.Griffin_Lim_Iter} iterations: "
          + json.dumps({k: float(f"{v:.5f}") for k, v in sc.items()})
          + f"; dense vs staged relative gap {gap:.4f} (tolerance 0.05); momentum "
          f"{'better' if sc['f dense momentum'] < sc['f dense'] else 'NOT better'} than plain "
          f"(dense), {'better' if sc['e staged momentum'] < sc['a staged'] else 'NOT better'} "
          "(staged, printed only)")
    if not gap <= 0.05:
        failures.append(f"dense vs staged spectral convergence gap {gap} > 0.05")
    if not sc["f dense momentum"] < sc["f dense"]:
        failures.append(f"momentum did not converge tighter on the dense kernel: {sc}")

    # (g) Streaming: the mel-only configuration (the CBHG head cannot stream),
    # segment_steps = 16, default decode and int8_pallas. Warm-up stream,
    # then the counted one (counts zeroed just before), then synthesize
    # under the same seed for the mel.
    hp_stream = hp.replace(Linear_Head={"Use": False})
    stream_res = {}
    for label, quantize, decode in (("g stream", None, None),
                                    ("g stream int8_pallas", "int8_pallas", "decode_segment_int8")):
        synth = Synthesizer(hp_stream, params, batch_stats, seed=0, quantize=quantize)
        list(synth.stream(TEXTS, emb, segment_steps=16, pcm16=True))
        for store in (*recorded.values(), *plain_calls.values()):
            store.clear()
        for k in kernels.values():
            k.launches = 0
        gc.collect()  # as in run_pass
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks, t_first = [], None
        for c in synth.stream(TEXTS, emb, segment_steps=16, pcm16=True, return_mel=True):
            if t_first is None:
                t_first = time.perf_counter() - t0
            chunks.append(c)
        t_all = time.perf_counter() - t0
        counts = {name: k.launches for name, k in kernels.items()}
        gl_T = sorted({c[0][0].shape[1] for c in recorded["griffin_lim_staged"]})
        n_plain = {name: len(v) for name, v in plain_calls.items()}
        ref = synth.synthesize(TEXTS, emb)
        mel = np.concatenate([c["mel_chunk"] for c in chunks], axis=1)
        lens = [int(x) for x in chunks[-1]["mel_lengths"]]
        ref_lens = [item["mel_length"] for item in ref]
        mel_err = max(float(np.abs(mel[b, :T] - item["mel"]).max()) if T else 0.0
                      for b, (T, item) in enumerate(zip(lens, ref)))
        audio_s = sum(max(T - 1, 1) * hp.Sound.Frame_Shift for T in lens) / hp.Sound.Sample_Rate
        print(f"[{label}] {len(chunks)} chunks of {chunks[0]['wav_chunk'].shape}; mel_lengths "
              f"{lens} (synthesize {ref_lens}); launches {counts}; plain decode calls {n_plain}; "
              f"staged Griffin-Lim at T = {gl_T}; streamed mel vs synthesize max abs "
              f"{mel_err:.3e} (tolerance 1e-4); first chunk after {t_first * 1e3:.1f} ms, "
              f"whole stream {t_all * 1e3:.1f} ms for {audio_s:.2f} s of audio = "
              f"{audio_s / t_all:.2f}x real time")
        stream_res[label] = {"launches": counts, "t_first": t_first, "t_all": t_all,
                             "audio_s": audio_s, "gl_T": gl_T, "mel_err": mel_err}
        if counts["griffin_lim_staged"] != len(chunks) or gl_T != [47]:
            failures.append(f"[{label}] staged launches {counts['griffin_lim_staged']} for "
                            f"{len(chunks)} windows at T = {gl_T} (want 47)")
        if decode and (counts[decode] == 0 or any(n_plain.values())):
            failures.append(f"[{label}] decode launches {counts[decode]}, plain {n_plain}")
        if lens != ref_lens:
            failures.append(f"[{label}] streamed mel_lengths {lens} != synthesize {ref_lens}")
        if not mel_err <= 1e-4:
            failures.append(f"[{label}] streamed mel differs from synthesize by {mel_err}")
        for c in chunks:
            w = c["wav_chunk"]
            if w.dtype != np.int16 or w.shape != (len(TEXTS), 16 * r * hp.Sound.Frame_Shift):
                failures.append(f"[{label}] chunk {w.dtype} {w.shape}")
                break
        if label == "g stream":
            busy_ms, _ = _profile(label, lambda: list(synth.stream(TEXTS, emb, segment_steps=16,
                                                                   pcm16=True)))
            print(f"[{label}] device idle, unprofiled stream: busy {busy_ms:.1f} ms (profiled "
                  f"repeat) of {t_all * 1e3:.1f} ms = {100 * (1 - busy_ms / (t_all * 1e3)):.1f}% idle")
        del synth

    # 2b. Train phase --------------------------------------------------------
    # The checkpoint with the YAML default Speaker_Embedding.GE2E.Freeze:
    # false, so gradients reach the GE2E encoder: teacher-forced steps on a
    # batch of 32 at the checkpoint's buckets.
    from multi_speaker_tts_tpu_torch.train.trainer import Trainer

    train_names = ("ge2e_lstm_layer_residuals", "ge2e_lstm_bwd", "text_encoder_bilstm_residuals",
                   "text_encoder_bilstm_bwd", "cbhg_bigru_residuals", "cbhg_bigru_bwd")
    per_step = {"ge2e_lstm_layer_residuals": 3, "ge2e_lstm_bwd": 3,
                "text_encoder_bilstm_residuals": 1, "text_encoder_bilstm_bwd": 1,
                "cbhg_bigru_residuals": 1, "cbhg_bigru_bwd": 1, "ge2e_lstm_layer": 0,
                "text_encoder_bilstm": 0, "cbhg_bigru": 0}
    hp_train = hp.replace(Speaker_Embedding={"GE2E": {"Freeze": False}})
    batch = _train_batch(hp, TRAIN_BATCH, seed=0)
    frames = int(batch["mel_lengths"].sum())
    print(f"[train] batch {TRAIN_BATCH}: tokens {batch['tokens'].shape}, mels "
          f"{batch['mels'].shape}, refs {batch['ref_mels'].shape}, spects "
          f"{batch['spects'].shape}, {frames} mel frames")
    trainer = Trainer.from_params(hp_train, params, batch_stats, seed=0)  # -> cuda
    recurrent = [(n, t) for n, t in zip(trainer.param_names, trainer.params)
                 if "lstm" in n or "gru" in n]
    t0 = time.perf_counter()
    trainer.train_step(batch)  # warm-up: libraries, packed weights, cuBLAS choices
    torch.cuda.synchronize()
    print(f"[train] warm-up step {1e3 * (time.perf_counter() - t0):.1f} ms")
    for store in (*recorded.values(), *plain_bwd.values()):
        store.clear()
    for k in kernels.values():
        k.launches = 0
    gc.collect()  # as in run_pass
    step_ms, train_metrics = [], []
    for i in range(TRAIN_STEPS):
        counts = {name: k.launches for name, k in kernels.items()}
        before = [t.detach().clone() for _, t in recurrent]
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = trainer.train_step(batch)
        stop.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(stop))
        train_metrics.append(m)
        delta = {name: kernels[name].launches - counts[name] for name in per_step}
        if delta != per_step:
            failures.append(f"[train] step {i}: launches {delta}, want {per_step}")
        if m["skipped_nonfinite"] or not all(math.isfinite(v) for v in m.values()):
            failures.append(f"[train] step {i}: metrics {m}")
        still = [n for (n, t), b in zip(recurrent, before) if torch.equal(t.detach(), b)]
        if len(still) == len(recurrent):
            failures.append(f"[train] step {i}: no recurrent weight changed")
        elif still:
            print(f"[train] step {i}: unchanged by this step's update (under an f32 ulp at "
                  f"this learning rate): {still}")
    train_launches = {name: kernels[name].launches for name in train_names}
    train_rec = {name: list(recorded[name]) for name in
                 ("ge2e_lstm_layer", "ge2e_lstm_bwd", "text_encoder_bilstm",
                  "text_encoder_bilstm_bwd", "cbhg_bigru", "cbhg_bigru_bwd")}
    if any(plain_bwd.values()):
        failures.append(f"[train] a plain backward ran on the card: "
                        f"{ {k: len(v) for k, v in plain_bwd.items()} }")
    ms = sum(step_ms) / len(step_ms)
    print(f"[train] {TRAIN_STEPS} steps (CUDA events): "
          + json.dumps([round(x, 2) for x in step_ms]) + f" ms; mean {ms:.2f} ms a step, "
          f"{frames / (ms / 1e3):.0f} mel frames/s")
    print("[train] metrics: " + json.dumps([{k: round(v, 5) for k, v in m.items()}
                                              for m in train_metrics]))
    print(f"[train] launches over the {TRAIN_STEPS} steps: {train_launches}; plain backward "
          f"calls {({k: len(v) for k, v in plain_bwd.items()})}")
    busy_ms, _ = _profile("train step", lambda: trainer.train_step(batch))
    ops_fn = _profile.last_ops
    print(f"[train] device idle, one step: busy {busy_ms:.1f} ms (profiled step) of {ms:.1f} "
          f"ms (unprofiled mean) = {100 * (1 - busy_ms / ms):.1f}% idle")
    # The same step with the decoder scan under autograd (decoder_tf_scan_ref,
    # the Python loop's graph), in this run: what the hand-written backward
    # (decoder_tf_scan, an autograd Function) changed. Host-bound steps vary
    # by 2x between calls, so the two alternate, 5 rounds, and their medians
    # are compared.
    tf_scan = decoder_scan.decoder_tf_scan

    def timed_step():
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        gc.collect()
        start.record()
        trainer.train_step(batch)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop)

    fn_ms, ref_ms = [], []
    try:
        for _ in range(5):
            decoder_scan.decoder_tf_scan = tf_scan
            fn_ms.append(timed_step())
            decoder_scan.decoder_tf_scan = decoder_scan.decoder_tf_scan_ref
            ref_ms.append(timed_step())
        busy_ref, _ = _profile("train step, scan under autograd",
                               lambda: trainer.train_step(batch))
        ops_ref = _profile.last_ops
    finally:
        decoder_scan.decoder_tf_scan = tf_scan
    print(f"[train] decoder scan, alternating steps: the Function median "
          f"{statistics.median(fn_ms):.2f} ms a step ({json.dumps([round(x, 2) for x in fn_ms])}), "
          f"{ops_fn} device ops (busy {busy_ms:.1f} ms); under autograd median "
          f"{statistics.median(ref_ms):.2f} ms ({json.dumps([round(x, 2) for x in ref_ms])}), "
          f"{ops_ref} device ops (busy {busy_ref:.1f} ms) ({_smi()})")
    print(f"[train] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # One extra teacher-forced forward (no graph, after the timed steps):
    # attention_block's inputs and the memory at frame 32, the train-shape
    # case of the attention-step probe (h).
    attn_rec, scan_rec = [], []
    _record(decoder_scan, "attention_block", attn_rec)
    _record(decoder_scan, "decoder_tf_scan", scan_rec)
    try:
        trainer.eval_step(batch)
    finally:
        _restore(decoder_scan, "attention_block", "decoder_tf_scan")
    (h_tf, w_tf, cum_tf, keys_tf, ap_tf, mask_tf), _, _ = attn_rec[32]
    train_attention = (decoder_scan.AttentionParams(*(t.detach() for t in ap_tf)),
                       keys_tf.contiguous(), scan_rec[0][0][3].float().contiguous(), mask_tf,
                       h_tf.contiguous(), w_tf.contiguous(), cum_tf.contiguous())
    # One call of the Function against decoder_tf_scan_ref under autograd, on
    # the call's own inputs and seeded cotangents: f32 compute (gated 1e-3 of
    # each gradient's peak) and the train step's bf16 (bf16 residuals and dG
    # against autograd's f32 ones; gated 5e-2).
    p_s, pre_s, keys_s, mem_s, mask_s, _ = scan_rec[0][0]
    gen = torch.Generator("cuda").manual_seed(0)
    leaves = [t.detach().clone().requires_grad_() for t in
              [w for q in p_s.lstm for w in q] + list(p_s.attention) + [pre_s, keys_s, mem_s]]
    n_l = len(p_s.lstm)
    p_leaf = decoder_scan.DecoderParams(
        tuple(decoder_scan.LSTMParams(*leaves[3 * i:3 * i + 3]) for i in range(n_l)),
        decoder_scan.AttentionParams(*leaves[3 * n_l:3 * n_l + 4]), None, None)
    px = py = None
    scan_err = {}
    for cd_name, cd in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        got = []
        for fn in (decoder_scan.decoder_tf_scan_ref, decoder_scan.decoder_tf_scan):
            xs_, ws_ = fn(p_leaf, *leaves[-3:], mask_s.detach(), cd)
            if px is None:
                px = torch.randn(xs_.shape, generator=gen, device="cuda")
                py = torch.randn(ws_.shape, generator=gen, device="cuda")
            got.append(torch.autograd.grad((xs_ * px).sum() + (ws_ * py).sum(), leaves))
        scan_err[cd_name] = max(float((a - b).abs().max() / a.abs().max().clamp(min=1e-12))
                                for a, b in zip(*got))
    print(f"[train] decoder scan gradients, the Function against autograd on one call's "
          f"inputs (T {pre_s.shape[0]}, B {pre_s.shape[1]}): largest error over each "
          f"gradient's peak f32 {scan_err['f32']:.2e} (tolerance 1e-3), bf16 "
          f"{scan_err['bf16']:.2e} (tolerance 5e-2)")
    if not (scan_err["f32"] <= 1e-3 and scan_err["bf16"] <= 5e-2):
        failures.append(f"[train] decoder scan gradients: {scan_err}")
    del attn_rec, scan_rec, trainer, leaves, p_leaf

    # Freeze: true (the checkpoint as it is): the encoder runs without a
    # graph, the LSTM backward never launches and its weights stay bit-equal.
    trainer = Trainer.from_params(hp, params, batch_stats, seed=0)
    ge2e_before = [t.detach().clone() for t in trainer.ge2e.parameters()]
    counts = {name: k.launches for name, k in kernels.items()}
    m = trainer.train_step(batch)
    torch.cuda.synchronize()
    delta = {name: kernels[name].launches - counts[name] for name in per_step}
    frozen_ok = all(torch.equal(a, t.detach()) for a, t in zip(ge2e_before,
                                                               trainer.ge2e.parameters()))
    print(f"[train] Freeze: true: launches {delta}; GE2E bit-equal after the step: {frozen_ok}; "
          f"total {m['total']:.5f}, skipped {m['skipped_nonfinite']}")
    if delta["ge2e_lstm_bwd"] or delta["ge2e_lstm_layer_residuals"] or not frozen_ok:
        failures.append(f"[train] Freeze: true: launches {delta}, GE2E unchanged {frozen_ok}")
    if delta["ge2e_lstm_layer"] != 3 or m["skipped_nonfinite"]:
        failures.append(f"[train] Freeze: true: {delta}, {m}")
    del trainer

    # Whole step, card against the port's plain path on the CPU: every
    # dropout rate 0, the same weights, the first 8 rows of the batch (gated)
    # and all 32 (printed only). At 32 the gradient norm is dominated by two
    # rows (the same wav and text, two reference crops) whose speaker-
    # embedding gradient is ill-conditioned in bf16: it moves by several
    # times with the rounding, on either device, so that comparison measures
    # the conditioning, not the port (PERF.md, section 6).
    no_dropout = dict(Decoder={"Prenet": {"Dropout_Rate": 0.0}},
                      Encoder={"Conv": {"Dropout_Rate": 0.0}},
                      Postnet={"Conv": {"Dropout_Rate": 0.0}},
                      Linear_Head={"Conv": {"Dropout_Rate": 0.0}})
    hp0 = hp_train.replace(**no_dropout)
    for rows, gated in ((8, True), (TRAIN_BATCH, False)):
        part = {k: v[:rows] for k, v in batch.items()}
        on_card = Trainer.from_params(hp0, params, batch_stats, seed=0).train_step(part)
        t0 = time.perf_counter()
        on_cpu = Trainer.from_params(hp0, params, batch_stats, device="cpu",
                                     seed=0).train_step(part)
        t_cpu = time.perf_counter() - t0
        errs = {k: abs(on_card[k] - on_cpu[k]) / max(abs(on_cpu[k]), 1e-12)
                for k in on_cpu if k != "skipped_nonfinite"}
        print(f"[train] whole step, card vs plain CPU (B = {rows}, dropout 0; CPU step "
              f"{t_cpu:.1f} s; {'gated' if gated else 'printed, not gated'}): grad_norm "
              f"{on_card['grad_norm']:.4f} vs {on_cpu['grad_norm']:.4f}; relative errors "
              + json.dumps({k: float(f"{v:.2e}") for k, v in errs.items()})
              + "; tolerance 1e-2 each loss, 2e-2 grad_norm")
        for k, v in errs.items():
            if gated and not v <= (2e-2 if k == "grad_norm" else 1e-2):
                failures.append(f"[train] whole step {k}: card {on_card[k]} vs CPU {on_cpu[k]}")

    # 2c. Attention-step probe (h) -------------------------------------------
    # The port's tools/attention_probe.py: the plain loop (attention_block +
    # the context bmm) and the kernel loop (one attention_step launch a
    # step), 200 dependent steps each, at the probe's defaults (seeded
    # random weights) and at the train phase's recorded frame with the
    # checkpoint's attention weights. Counts zeroed just before each counted
    # loop and read just after; the plain attention step must not run in
    # the kernel loop, nor the kernel in the plain loop.
    probe_args = attention_probe.parser().parse_args([])
    n_it = probe_args.iters
    g_attn = torch.Generator("cuda").manual_seed(13)

    def rel_peak3(got, ref):
        return {k: ((g - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()
                for k, g, r in zip(("w", "cum", "ctx"), got, ref)}

    def probe_case(label, case):
        ap, keys, memory, mask, h0, w0, cum0 = case
        plain = attention_probe.make_plain_loop(ap, keys, memory, mask, n_it)
        kern = attention_probe.make_kernel_loop(ap, keys, memory, mask, n_it)
        plain(h0, w0, cum0)
        kern(h0, w0, cum0)
        torch.cuda.synchronize()
        stores = {"attention_block": [], "attention_step_plain": [], "attention_step_kernel": []}
        _record(decoder_scan, "attention_block", stores["attention_block"])
        _record(attention_step_kernel, "attention_step_plain", stores["attention_step_plain"])
        _record(attention_step_kernel, "attention_step_kernel", stores["attention_step_kernel"])
        counted = {}
        try:
            for name, fn in (("kernel", kern), ("plain", plain)):
                for store in stores.values():
                    store.clear()
                attention_step_kernel.KERNEL.launches = 0
                out = fn(h0, w0, cum0)
                torch.cuda.synchronize()
                counted[name] = {"out": out, "launches": attention_step_kernel.KERNEL.launches,
                                 "calls": {k: len(v) for k, v in stores.items()}}
                if name == "kernel":  # the middle step's inputs, for the kernel row
                    mid = stores["attention_step_kernel"][n_it // 2][0]
        finally:
            _restore(decoder_scan, "attention_block")
            _restore(attention_step_kernel, "attention_step_plain", "attention_step_kernel")
        ck, cp = counted["kernel"], counted["plain"]
        if (ck["launches"] != n_it or ck["calls"]["attention_block"]
                or ck["calls"]["attention_step_plain"]):
            failures.append(f"[h {label}] kernel loop: {ck['launches']} launches for {n_it} "
                            f"steps, plain calls {ck['calls']}")
        if cp["launches"] or cp["calls"]["attention_block"] != n_it:
            failures.append(f"[h {label}] plain loop: {cp['launches']} launches, calls "
                            f"{cp['calls']}")
        loop_err = rel_peak3(ck["out"], cp["out"])
        # The plain loop against itself on h0 moved by 1e-6 of itself (seeded):
        # how far the loop alone carries a last-bit difference.
        noise = torch.randn(h0.shape, generator=g_attn, device=h0.device)
        loop_probe = rel_peak3(plain(h0 * (1.0 + 1e-6 * noise), w0, cum0), cp["out"])
        t_plain = attention_probe.time_loop(plain, h0, w0, cum0)
        t_kern = attention_probe.time_loop(kern, h0, w0, cum0)
        t_kern2 = attention_probe.time_loop(kern, h0, w0, cum0)
        t_plain2 = attention_probe.time_loop(plain, h0, w0, cum0)
        us = {"plain": 1e6 * (t_plain + t_plain2) / 2 / n_it,
              "kernel": 1e6 * (t_kern + t_kern2) / 2 / n_it}
        idle, busy_us = {}, {}
        for name, fn in (("plain", plain), ("kernel", kern)):
            busy_ms, _ = _profile(f"h {label} {name} loop", lambda fn=fn: fn(h0, w0, cum0))
            idle[name] = 1 - busy_ms / (us[name] * n_it / 1e3)
            busy_us[name] = 1e3 * busy_ms / n_it
        B_, S_, A_ = keys.shape
        print(f"[h {label}] B {B_}, S {S_}, A {A_}, D {memory.shape[-1]}, H {h0.shape[-1]}, "
              f"{n_it} steps; launches: kernel loop {ck['launches']} (plain calls "
              f"{ck['calls']}), plain loop {cp['launches']} (calls {cp['calls']}); us a step "
              f"(CUDA events, two-point slope, plain / kernel / kernel / plain): plain "
              f"{1e6 * t_plain / n_it:.2f}, {1e6 * t_plain2 / n_it:.2f}; kernel "
              f"{1e6 * t_kern / n_it:.2f}, {1e6 * t_kern2 / n_it:.2f}; verdict kernel/plain = "
              f"{us['kernel'] / us['plain']:.3f}x; device busy a step (profiled repeat): plain "
              f"{busy_us['plain']:.2f} us, kernel {busy_us['kernel']:.2f} us; device idle over "
              f"the timed loops: plain {100 * idle['plain']:.1f}%, kernel "
              f"{100 * idle['kernel']:.1f}%")
        print(f"[h {label}] looped outputs max |kernel - plain| / max |plain|: "
              + json.dumps({k: float(f"{v:.3e}") for k, v in loop_err.items()})
              + " (tolerance 1e-3); the plain loop on h0 moved by 1e-6: "
              + json.dumps({k: float(f"{v:.3e}") for k, v in loop_probe.items()}))
        return {"mid": mid, "loop_err": loop_err, "loop_probe": loop_probe, "us": us,
                "idle": idle, "busy_us": busy_us, "launches": ck["launches"]}

    attn_res = {
        "probe": probe_case("probe", attention_probe.probe_inputs(probe_args, 0, "cuda")),
        "train": probe_case("train shape", train_attention),
    }

    # 2d. The serving daemon (i) --------------------------------------------
    # serve.TTSServer over the checkpoint as it is under bf16_pallas, on
    # 127.0.0.1 (port 0), max_batch 8 and a 250 ms window: /enroll, GET
    # /speakers, 8 concurrent /synthesize (the four texts twice, by speaker
    # name), one Accept: audio/wav, the malformed payloads of _parse_request,
    # /stream on this checkpoint (501: the CBHG head cannot stream), and
    # /stream through a second server over the mel-only configuration. One
    # warm-up request first, through a batcher of its own (it packs the bf16
    # gate weights); the counts are zeroed after it. The
    # worker's synthesize calls are recorded; the plain versions of the six
    # forward kernels must not run.
    import base64
    import concurrent.futures
    import io as io_lib
    import urllib.error
    import urllib.request

    from multi_speaker_tts_tpu_torch import serve
    from multi_speaker_tts_tpu_torch.audio import wav_io as port_wav_io

    def http(method, url, body=None, headers=None):
        req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                return resp.status, resp.headers.get("Content-Type"), resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("Content-Type"), e.read()

    def post_json(url, payload, headers=None):
        return http("POST", url, json.dumps(payload).encode(),
                    {"Content-Type": "application/json", **(headers or {})})

    def stream_chunks(port_, payload):
        """POST /stream on a raw socket -> (status line, [chunk payloads]);
        a reply that is not chunked comes back as one payload."""
        import socket

        body = json.dumps(payload).encode()
        with socket.create_connection(("127.0.0.1", port_), timeout=300) as sock:
            sock.sendall(b"POST /stream HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                         b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
            buf = b""

            def need(n):
                nonlocal buf
                while len(buf) < n:
                    data = sock.recv(65536)
                    if not data:
                        raise ConnectionError("the server closed the connection")
                    buf += data

            while b"\r\n\r\n" not in buf:
                need(len(buf) + 1)
            head, buf = buf.split(b"\r\n\r\n", 1)
            status = head.split(b"\r\n")[0]
            if b"Transfer-Encoding: chunked" not in head:
                n = [int(x.split(b":")[1]) for x in head.split(b"\r\n")
                     if x.lower().startswith(b"content-length:")]
                need(n[0] if n else 0)
                return status, [buf]
            chunks = []
            while True:
                while b"\r\n" not in buf:
                    need(len(buf) + 1)
                size_line, buf = buf.split(b"\r\n", 1)
                size = int(size_line, 16)
                need(size + 2)
                if size == 0:
                    return status, chunks
                chunks.append(buf[:size])
                buf = buf[size + 2:]

    def wav_pcm(blob):
        from scipy.io import wavfile

        return wavfile.read(io_lib.BytesIO(blob))[1]

    plain_fwd = {name: [] for name in ("melspectrogram_plain", "lstm_seq_layer_plain",
                                       "bilstm_recurrence_plain", "bigru_recurrence_plain",
                                       "griffin_lim_staged_plain")}
    plain_mods = {"melspectrogram_plain": mel_kernel, "lstm_seq_layer_plain": lstm_kernel,
                  "bilstm_recurrence_plain": birnn_kernel, "bigru_recurrence_plain": birnn_kernel,
                  "griffin_lim_staged_plain": griffin_lim_staged}
    for name, store in plain_fwd.items():
        _record(plain_mods[name], name, store)
    synth_d = Synthesizer(hp, params, batch_stats, seed=0, quantize="bf16_pallas")
    worker_calls = []

    def worker_synthesize(texts, *a, **k):
        out = Synthesizer.synthesize(synth_d, texts, *a, **k)
        worker_calls.append((list(texts), a, k, out))
        return out

    synth_d.synthesize = worker_synthesize
    warm = serve.DynamicBatcher(synth_d, max_batch=8, max_wait_ms=250.0, pcm16=True)
    warm.submit(TEXTS[0], emb)
    warm.close()
    daemon = serve.TTSServer(synth_d, host="127.0.0.1", port=0, max_batch=8, max_wait_ms=250.0,
                             pcm16=True)
    daemon.start_background()
    hp_mel = hp.replace(Linear_Head={"Use": False})
    synth_m = Synthesizer(hp_mel, params, batch_stats, seed=0, quantize="bf16_pallas")
    daemon_m = serve.TTSServer(synth_m, host="127.0.0.1", port=0, max_batch=8, pcm16=True)
    daemon_m.start_background()
    base = f"http://127.0.0.1:{daemon.port}"
    hop_i = synth_d.dsp_cfg.hop
    worker_calls.clear()
    for store in (*recorded.values(), *plain_calls.values(), *plain_fwd.values()):
        store.clear()
    for k in kernels.values():
        k.launches = 0
    gc.collect()  # as in run_pass
    daemon_fail = []
    try:
        # 1-2: enroll one wav, list the speakers.
        st, _, body = http("POST", f"{base}/enroll?name=spk0", ENROLL[0].read_bytes())
        if st != 200 or not json.loads(body).get("ok"):
            daemon_fail.append(f"/enroll: {st} {body[:200]!r}")
        st, _, body = http("GET", f"{base}/speakers")
        if st != 200 or json.loads(body) != ["spk0"]:
            daemon_fail.append(f"/speakers: {st} {body[:200]!r}")
        # 3: the burst, 8 concurrent requests by speaker name.
        burst = [TEXTS[i % len(TEXTS)] for i in range(8)]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            replies = list(pool.map(lambda t: post_json(f"{base}/synthesize",
                                                        {"text": t, "speaker": "spk0"}), burst))
        t_burst = time.perf_counter() - t0
        # 4: raw wav.
        raw = post_json(f"{base}/synthesize", {"text": TEXTS[2], "speaker": "spk0"},
                        {"Accept": "audio/wav"})
        # 5: the malformed payloads, against the port's own _parse_request.
        bad = [{"speaker": "spk0"}, {"text": "   ", "speaker": "spk0"}, {"text": 7},
               {"text": "x", "speaker": "nobody"}, {"text": "x"},
               {"text": "x", "speaker_embedding": [0.5, 0.5]},
               {"text": "x", "speaker": "spk0", "max_steps": "many"},
               {"text": "x", "speaker": "spk0", "max_steps": 0}]
        for payload in bad:
            want = daemon._parse_request(payload)[1]
            got = post_json(f"{base}/synthesize", payload)
            if want is None or got[0] != 400 or got[0] != want[0] or got[2] != want[2]:
                daemon_fail.append(f"malformed {payload}: {got[0]} {got[2][:120]!r}, want {want}")
        # 6: /stream on the CBHG checkpoint.
        line_full, body_full = stream_chunks(daemon.port, {"text": TEXTS[0], "speaker": "spk0"})
        if b" 501 " not in line_full + b" ":
            daemon_fail.append(f"/stream on the CBHG head: {line_full!r} {body_full[:1]!r}")
        # 7: /stream on the mel-only server, against Synthesizer.stream.
        emb_d = daemon.registry.get("spk0")
        daemon_m.registry.register("spk0", emb_d)
        line_m, chunks_m = stream_chunks(daemon_m.port, {"text": TEXTS[1], "speaker": "spk0"})
        stats = json.loads(http("GET", f"{base}/stats")[2])
        # 8: a burst of 24 through a server with the default max_batch (32):
        # one batch of more than 16 requests, which _prepare pads to 32 rows,
        # two row groups of the decode kernel.
        daemon_b = serve.TTSServer(synth_d, host="127.0.0.1", port=0, max_wait_ms=250.0,
                                   pcm16=True)
        daemon_b.start_background()
        daemon_b.registry.register("spk0", emb_d)
        burst24 = [TEXTS[i % len(TEXTS)] for i in range(24)]
        decode_before = kernels["decode_segment_bf16"].launches
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(burst24)) as pool:
            replies24 = list(pool.map(lambda t: post_json(
                f"http://127.0.0.1:{daemon_b.port}/synthesize", {"text": t, "speaker": "spk0"}),
                burst24))
        t_burst24 = time.perf_counter() - t0
        decode24 = kernels["decode_segment_bf16"].launches - decode_before
        stats24 = json.loads(http("GET", f"http://127.0.0.1:{daemon_b.port}/stats")[2])
    finally:
        daemon.shutdown()
        daemon_m.shutdown()
        if "daemon_b" in locals():
            daemon_b.shutdown()
        for name in plain_fwd:
            _restore(plain_mods[name], name)
    counts_d = {name: k.launches for name, k in kernels.items()}
    plain_d = {**{k: len(v) for k, v in plain_fwd.items()},
               **{k: len(v) for k, v in plain_calls.items()}}
    # Every well-formed reply: 200, int16 PCM of max(mel_length - 1, 1) hop
    # samples, the bytes of a row the worker's own synthesize returned.
    rows_by_text = {}
    for texts, _, _, out in worker_calls:
        for t, item in zip(texts, out):
            rows_by_text.setdefault(t, []).append(serve._wav_bytes(item["wav"],
                                                                   synth_d.dsp_cfg.sample_rate))
    for t, (st, ctype, body) in zip(burst, replies):
        if st != 200:
            daemon_fail.append(f"/synthesize {t!r}: {st} {body[:200]!r}")
            continue
        item = json.loads(body)
        blob = base64.b64decode(item["wav_b64"])
        pcm = wav_pcm(blob)
        if pcm.dtype != np.int16 or len(pcm) != max(item["mel_length"] - 1, 1) * hop_i:
            daemon_fail.append(f"/synthesize {t!r}: {pcm.dtype} {pcm.shape}, mel_length "
                               f"{item['mel_length']}")
        if blob not in rows_by_text.get(t, []):
            daemon_fail.append(f"/synthesize {t!r}: the bytes are no row of the worker's")
        else:
            rows_by_text[t].remove(blob)
    if raw[0] != 200 or raw[1] != "audio/wav" or raw[2] not in rows_by_text.get(TEXTS[2], []):
        daemon_fail.append(f"Accept: audio/wav: {raw[0]} {raw[1]}, bytes of a worker row: "
                           f"{raw[2] in rows_by_text.get(TEXTS[2], [])}")
    # Each batch the worker ran, again directly: the same lengths and mels.
    batch_err = 0.0
    for texts, a, k, out in worker_calls:
        again = Synthesizer.synthesize(synth_d, texts, *a, **k)
        if [x["mel_length"] for x in again] != [x["mel_length"] for x in out]:
            daemon_fail.append(f"batch {texts}: direct lengths {[x['mel_length'] for x in again]}"
                               f" != served {[x['mel_length'] for x in out]}")
        else:
            batch_err = max(batch_err, *(float(np.abs(x["mel"] - y["mel"]).max())
                                         for x, y in zip(again, out)))
    if not batch_err <= 1e-4:
        daemon_fail.append(f"batches re-run directly: mels {batch_err} apart (tolerance 1e-4)")
    hist = {int(k): v for k, v in stats.get("batch_size_histogram", {}).items()}
    if not any(size >= 2 for size in hist):
        daemon_fail.append(f"no batch of 2 or more rows: {hist}")
    hist24 = {int(k): v for k, v in stats24.get("batch_size_histogram", {}).items()}
    bad24 = [(t, st, body[:120]) for t, (st, _, body) in zip(burst24, replies24) if st != 200]
    if bad24:
        daemon_fail.append(f"burst of 24: {len(bad24)} replies not 200, e.g. {bad24[:2]}")
    if not any(size > 16 for size in hist24):
        daemon_fail.append(f"burst of 24: no batch of more than 16 requests: {hist24}")
    rows32 = [c for c in worker_calls if len(c[0]) > 16]
    if not rows32 or decode24 == 0:
        daemon_fail.append(f"burst of 24: worker batches {[len(c[0]) for c in worker_calls]}, "
                           f"decode kernel launches {decode24}")
    for name in ("mel_frontend", "ge2e_lstm_layer", "text_encoder_bilstm", "cbhg_bigru",
                 "griffin_lim_staged", "decode_segment_bf16"):
        if counts_d[name] == 0:
            daemon_fail.append(f"kernel {name} was not launched on the daemon's path")
    if any(plain_d.values()):
        daemon_fail.append(f"a plain version ran on the card: {plain_d}")
    # The mel-only stream: >= 2 chunks, equal to Synthesizer.stream trimmed.
    want_pcm, final = [], 0
    for item in synth_m.stream([TEXTS[1]], emb_d, segment_steps=16, pcm16=True):
        want_pcm.append(item["wav_chunk"][0])
        final = int(item["mel_lengths"][0])
    want_pcm = np.concatenate(want_pcm)[:final * synth_m.dsp_cfg.hop]
    got_pcm = np.frombuffer(b"".join(chunks_m[1:]), "<i2")
    if b" 200 " not in line_m + b" " or len(chunks_m) - 1 < 2 or not np.array_equal(got_pcm,
                                                                                   want_pcm):
        daemon_fail.append(f"mel-only /stream: {line_m!r}, {len(chunks_m) - 1} chunks, "
                           f"{got_pcm.shape} vs {want_pcm.shape} samples")
    lat = stats.get("latency_ms", {})
    smi_d = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=False).stdout.strip()
    print(f"[i daemon] burst of {len(burst)} /synthesize: {t_burst * 1e3:.1f} ms wall, "
          f"{len(burst) / t_burst:.2f} requests/s; /stats latency p50 {lat.get('p50')} ms, p95 "
          f"{lat.get('p95')} ms over {lat.get('window')} requests; batch sizes {hist}; "
          f"compiled_programs {stats.get('compiled_programs')} ({smi_d})")
    print(f"[i daemon] burst of {len(burst24)} /synthesize through max_batch 32: "
          f"{t_burst24 * 1e3:.1f} ms wall, {len(burst24) / t_burst24:.2f} requests/s, "
          f"{sum(st == 200 for st, _, _ in replies24)} answered 200; /stats batch sizes {hist24}, "
          f"latency p50 {stats24.get('latency_ms', {}).get('p50')} ms, p95 "
          f"{stats24.get('latency_ms', {}).get('p95')} ms; bf16 decode launches {decode24} "
          f"(one a row group of 16 a chunk: "
          f"{len(decode_kernel.row_groups(32))} groups at the 32-row bucket) ({smi_d})")
    print(f"[i daemon] worker batches {[len(c[0]) for c in worker_calls]}; re-run directly: "
          f"largest mel difference {batch_err:.3e} (tolerance 1e-4); launches {counts_d}; plain "
          f"calls {plain_d}; /stream on the CBHG head {line_full.decode(errors='replace')}; "
          f"mel-only /stream {len(chunks_m) - 1} chunks, {got_pcm.size} samples equal to "
          f"Synthesizer.stream: {np.array_equal(got_pcm, want_pcm)}")
    failures.extend(f"[i daemon] {f}" for f in daemon_fail)
    del synth_d, synth_m, daemon, daemon_m, daemon_b, warm

    # 2d'. Long texts (o): S past the JAX package's 256 up to the decode
    # kernel's own limit, row groups sized by its shared memory, the plain
    # loop past it, and a daemon burst with a long text ------------------
    t_o = time.perf_counter()
    fails_o, o_chunks = long_text_pass(params, batch_stats, hp, wavs, kernels, recorded,
                                       plain_calls, post_json)
    failures.extend(fails_o)
    print(f"[o] pass (o) took {time.perf_counter() - t_o:.1f} s")

    # 2e. Training end to end (j), then (k): data-parallel training, sharded
    # synthesis, and the evaluation CLI on (j)'s export and corpus ----------
    import tempfile

    with tempfile.TemporaryDirectory() as work:
        work = pathlib.Path(work)
        failures.extend(train_end_to_end(kernels, per_step, plain_bwd, work))
        t_k = time.perf_counter()
        failures.extend(dp_train(params, batch_stats, hp))
        failures.extend(sharded_synthesis(params, batch_stats, hp, wavs, kernels))
        failures.extend(evaluate_pass(work / "export.msgpack", str(work / "corpus" / "patterns"),
                                      kernels))
        print(f"[k] pass (k) took {time.perf_counter() - t_k:.1f} s")
        # (l) a reference torch checkpoint converted and served, (m) the same
        # checkpoint as f32, (n) the tools.
        for label, run in (("l", lambda: convert_pass(params, batch_stats, meta, hp, wavs,
                                                      kernels, work)),
                           ("m", lambda: f32_pass(params, batch_stats, hp, wavs, kernels)),
                           ("n", lambda: tools_pass(work))):
            t_p = time.perf_counter()
            # Pass (n)'s tools run hundreds of steps: nothing of theirs is kept.
            _RECORDING[0] = label != "n"
            failures.extend(run())
            _RECORDING[0] = True
            print(f"[{label}] pass ({label}) took {time.perf_counter() - t_p:.1f} s")
        # (p) every batch and width the reference's gates admit: its own
        # captures keep what its kernel rows read.
        t_p = time.perf_counter()
        _RECORDING[0] = False
        fails_p, wide = widths_pass(kernels, work)
        _RECORDING[0] = True
        failures.extend(fails_p)
        print(f"[p] pass (p) took {time.perf_counter() - t_p:.1f} s")
        # (q) the LSTM family at every width the JAX gate admits, and the
        # reference's routes: its own captures keep what its rows read.
        t_p = time.perf_counter()
        _RECORDING[0] = False
        fails_q, family = lstm_family_pass(kernels, work)
        _RECORDING[0] = True
        failures.extend(fails_q)
        print(f"[q] pass (q) took {time.perf_counter() - t_p:.1f} s")
        # (r) the last shapes the reference's gates launch, and two hosts:
        # its own captures keep what its rows read.
        t_p = time.perf_counter()
        _RECORDING[0] = False
        fails_r, refs = reference_shapes_pass(kernels, work)
        _RECORDING[0] = True
        failures.extend(fails_r)
        print(f"[r] pass (r) took {time.perf_counter() - t_p:.1f} s")
    # (s) the HiFi-GAN generator's MRF kernels on the synthesis path, and
    # its MRF inputs at the cell's largest bucket for row #12.
    t_p = time.perf_counter()
    fails_s, hifi = hifigan_pass(params, batch_stats, hp, wavs)
    failures.extend(fails_s)
    print(f"[s] pass (s) took {time.perf_counter() - t_p:.1f} s")

    # 3. Kernel phase --------------------------------------------------------
    t_kernels = time.perf_counter()
    print(f"[time] the main path and passes (a)-(s) took {t_kernels - t_build:.1f} s")
    rows, row_end = [], [t_kernels]
    launches = dict(pa["launches"],
                    decode_segment_bf16=pb["launches"]["decode_segment_bf16"],
                    decode_segment_int8=pc["launches"]["decode_segment_int8"],
                    griffin_lim_staged_momentum=pe["launches"]["griffin_lim_staged_momentum"],
                    griffin_lim_dense=(pf_plain["launches"]["griffin_lim_dense"]
                                       + pf_mom["launches"]["griffin_lim_dense"]))
    rec = dict(pa["recorded"], decode_segment_bf16=pb["recorded"]["decode_segment_bf16"],
               decode_segment_int8=pc["recorded"]["decode_segment_int8"])

    def check(name, replaces, source, kernel_fn, plain_fn, err_fn, tol,
              bound, library_fn=None, warmup=3, reps=20, also=(), extra=None,
              queue_ahead=False):
        """Error over the timed inputs and the ``also`` (kernel_fn,
        plain_fn[, err_fn]) cases of other shapes; times at the first.
        ``err_fn`` gives one number or {label: number}, ``tol`` likewise;
        the first label is the row's ``max_abs_err``. ``library_fn`` maps a
        label to a call; ``library_ms`` is the fastest of them."""
        errs = []
        for k_fn, p_fn, *e_fn in ((kernel_fn, plain_fn), *also):
            got, ref = k_fn(), p_fn()
            torch.cuda.synchronize()
            e = (e_fn[0] if e_fn else err_fn)(got, ref)
            errs.append({k: float(v) for k, v in e.items()} if isinstance(e, dict)
                        else {"max_abs": float(e)})
        tols = tol if isinstance(tol, dict) else {"max_abs": tol}
        worst = {k: max(e[k] for e in errs) for k in tols}
        ok = all(math.isfinite(v) and v <= tols[k] for k, v in worst.items())
        lead = next(iter(tols))
        print(f"{name}: {'ok' if ok else 'FAILED'}; worst of {len(errs)} shape(s) "
              + json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()})
              + f", tolerance {json.dumps(tols)}; per shape "
              + json.dumps([{k: float(f"{v:.2e}") for k, v in e.items()} for e in errs]))
        if not ok:
            failures.append(f"{name}: error {worst} > {tols}")
        bound_ms, bound_by = bound
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": worst[lead], "tolerance": tols[lead],
            "ms": _time_ms(kernel_fn, warmup, reps, queue_ahead),
            "plain_ms": _time_ms(plain_fn, 1, max(1, reps // 4), queue_ahead),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        }
        if library_fn is not None:
            row["library_ms_each"] = {k: _time_ms(fn, warmup, reps)
                                      for k, fn in library_fn.items()}
            row["library_ms"] = min(row["library_ms_each"].values())
        row.update(extra or {})
        if len(tols) > 1:
            row["errors"], row["tolerances"] = worst, tols
        rows.append(row)
        # Since the previous row: this row's inputs, library modules and
        # ``extra`` timings included.
        print(f"[time] row {name} took {time.perf_counter() - row_end[0]:.1f} s")
        row_end[0] = time.perf_counter()

    def floor_ms(T, ndir, H):
        """The recurrences' sequential floor at these shapes: T rounds of
        their grid barrier alone on their grid (csrc/barrier_floor.cu), with
        the zeroed counter each call allocates, as theirs do."""
        return _time_ms(lambda: recurrence_floor.barrier_floor(T, ndir, H, "cuda"), 3, 20)

    def gru_floor_ms(T, B, H):
        """The BiGRU forward's sequential floor: T steps of its dependent
        chain alone (recurrent product, bf16 store of h, block barrier) on
        its grid (csrc/barrier_floor.cu), without the gates and the cell."""
        return _time_ms(lambda: recurrence_floor.gru_chain_floor(T, B, H, "cuda"), 3, 20)

    def step_split(T, H, one_step):
        """A GE2E row's per-step cost: its kernel on the first step alone
        and one barrier round, beside ``floor_ms`` at T steps (a further
        step costs (ms - one_step_ms) / (T - 1))."""
        return {"floor_ms": floor_ms(T, 1, H), "one_step_ms": _time_ms(one_step, 3, 20),
                "floor_one_round_ms": floor_ms(1, 1, H)}

    def cudnn_calls(lib, x):
        """The cuDNN yardstick of a recurrence: the bf16 module on the bf16
        input (the kernel's types; PyTorch does not flatten bf16 RNN weights,
        so cuDNN compacts them on every call) and its fp16 copy on the fp16
        input (same operand width, weights flattened once)."""
        lib16 = copy.deepcopy(lib).half()
        lib16.flatten_parameters()
        x16 = x.half()
        return {"bf16": lambda: lib(x), "fp16": lambda: lib16(x16)}

    def lstm_lib_of(w_hh, w_ih=None, b=None):
        """cuDNN's bf16 nn.LSTM with the port's (in, 4H) weights; with
        identity input weights and no bias where ``w_ih`` is None (its input
        is then the hoisted gates, as the backward rows take it)."""
        H_, H4_ = w_hh.shape
        dev_ = w_hh.device
        lib = torch.nn.LSTM(H4_ if w_ih is None else w_ih.shape[0], H_).to(
            device=dev_, dtype=torch.bfloat16)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(torch.eye(H4_, device=dev_) if w_ih is None else w_ih.t())
            lib.weight_hh_l0.copy_(w_hh.t())
            if b is None:
                lib.bias_ih_l0.zero_()
            else:
                lib.bias_ih_l0.copy_(b)
            lib.bias_hh_l0.zero_()
        lib.flatten_parameters()
        return lib

    def birnn_lib_of(cls, w_f, w_b, b_hh=(None, None)):
        """cuDNN's bf16 bidirectional ``cls`` (nn.LSTM or nn.GRU) on the
        hoisted gates of both directions: identity input weights, the port's
        (H, nG) recurrent weights, the recurrent biases ``b_hh`` (the GRU's
        b_hn) or none."""
        H_, G_ = w_f.shape
        dev_ = w_f.device
        lib = cls(2 * G_, H_, bidirectional=True).to(device=dev_, dtype=torch.bfloat16)
        e_, z_ = torch.eye(G_, device=dev_), torch.zeros(G_, G_, device=dev_)
        with torch.no_grad():
            for sfx, w_in, w_, bh_ in (("", torch.cat([e_, z_], dim=1), w_f, b_hh[0]),
                                       ("_reverse", torch.cat([z_, e_], dim=1), w_b, b_hh[1])):
                getattr(lib, "weight_ih_l0" + sfx).copy_(w_in)
                getattr(lib, "weight_hh_l0" + sfx).copy_(w_.t())
                getattr(lib, "bias_ih_l0" + sfx).zero_()
                if bh_ is None:
                    getattr(lib, "bias_hh_l0" + sfx).zero_()
                else:
                    getattr(lib, "bias_hh_l0" + sfx).copy_(bh_)
        lib.flatten_parameters()
        return lib

    # The recurrences' bounds: inputs, weights and outputs once (residual
    # modes: the gates and c_{t-1}, 5H a row a step), 2 operations a MAC.
    def lstm_fwd_bound(p_, x_, residuals):
        T_, B_, D_ = x_.shape
        H_ = p_.hidden_size
        res_ = T_ * B_ * 5 * H_ if residuals else 0
        return _bound_ms(2 * (T_ * B_ * D_ + 4 * H_ * (D_ + H_) + T_ * B_ * H_ + res_)
                         + 4 * (4 * H_ + 2 * B_ * H_), 2 * T_ * B_ * 4 * H_ * (D_ + H_),
                         BF16_FLOPS)

    def bilstm_bound(g_, residuals):
        S_, B_, H4_ = g_.shape
        H_ = H4_ // 4
        res_ = 2 * S_ * B_ * 5 * H_ if residuals else 0
        return _bound_ms(2 * (2 * S_ * B_ * H4_ + 2 * H4_ * H_ + 2 * S_ * B_ * H_ + res_),
                         2 * 2 * S_ * B_ * H4_ * H_, BF16_FLOPS)

    def gru_bound(gf_, res):
        T_, B_, H3_ = gf_.shape
        H_ = H3_ // 3
        out = 2 * T_ * B_ * H_ * (2 + (2 * 4 if res else 0))  # ys (+ gh, h_{t-1}), both dirs
        return _bound_ms(2 * (2 * T_ * B_ * H3_ + 2 * H_ * H3_) + out + 4 * 2 * H3_,
                         2 * 2 * T_ * B_ * H_ * H3_, BF16_FLOPS)

    def max_abs(a, b):
        if isinstance(a, tuple):
            return max(max_abs(x, y) for x, y in zip(a, b))
        return (a.float() - b.float()).abs().max().item()

    # Mel front-end: (1, L + n_fft) padded signal -> (1, T, 80), f32. The
    # bound counts the least work of the function: the signal in, the mels
    # out, the basis's nonzeros; a frame's N-point real transform as the
    # window (N), an N/2-point complex FFT (5 (N/2) log2(N/2)) and its split
    # into the real transform's bins (~10 a bin), then the magnitudes (3 a
    # bin) and the bands (2 a nonzero); dft_bound_ms the DFT matmul's (the
    # TPU kernel's formulation: the (n_fft, F) table read once, 4 n_fft F
    # operations a frame).
    (y_pad, T, cfg), _, _ = rec["mel_frontend"][0]
    (mel_wav, _), _, _ = rec["mel_wav"][0]
    B, Lp = y_pad.shape
    F_bins = cfg.n_fft // 2 + 1
    nnz = int(np.count_nonzero(mel_kernel.mel_filterbank(
        cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.f_min, cfg.f_max)))
    dft_bound = _bound_ms(
        4 * (B * Lp + cfg.n_fft * F_bins * 2 + F_bins * cfg.n_mels + B * T * cfg.n_mels),
        B * T * (4 * cfg.n_fft * F_bins + 3 * F_bins + 2 * F_bins * cfg.n_mels), F32_FLOPS)
    check(
        "mel_frontend", "multi_speaker_tts_tpu/ops/mel_kernel.py:151",
        "multi_speaker_tts_tpu_torch/csrc/mel.cu",
        lambda: mel_kernel.melspectrogram_kernel.original(y_pad, T, cfg),
        lambda: mel_kernel.melspectrogram_plain(y_pad, T, cfg),
        max_abs, 1e-4,
        _bound_ms(4 * (B * Lp + nnz + B * T * cfg.n_mels),
                  B * T * (cfg.n_fft + 5 * (cfg.n_fft // 2) * math.log2(cfg.n_fft // 2)
                           + 10 * (cfg.n_fft // 2) + 3 * F_bins + 2 * nnz),
                  F32_FLOPS),
        extra={"shape": [B, T, cfg.n_fft, cfg.hop], "dft_bound_ms": dft_bound[0],
               "fft_route_ms": _time_ms(lambda: dsp.melspectrogram(mel_wav, cfg), 3, 20, True),
               "bound_note": "real-FFT work a frame: N + 5 (N/2) log2(N/2) + 10 (N/2) + 3 F "
                             "+ 2 nnz(basis) operations; fft_route_ms: dsp.melspectrogram "
                             "(torch.stft), timed only"},
        queue_ahead=True,  # a call's host dispatch outlasts the kernel
    )

    # Mel front-end, the DFT route (an n_fft that is not a power of two): the
    # three demo wavs (zero-padded to a multiple of hop) through
    # dsp.melspectrogram_auto at n_fft / hop 800 / 200 and 600 / 150, the JAX
    # rule's fused route (the wrapper raised there before this route),
    # counts zeroed just before each width's three calls and read just after:
    # three DFT launches, no FFT launch. One row a width, timed on the first
    # wav's padded signal, its error the worst of the three. The bound is the
    # FFT row's least work at this N; dft_bound_ms the DFT's own operations
    # (2 N F FMAs a frame) and its table; library_ms torch.stft and the basis
    # product, timed only.
    import dataclasses

    for n_fft_d, hop_d in ((800, 200), (600, 150)):
        name = f"mel_frontend_dft_{n_fft_d}"
        cfg_d = dataclasses.replace(cfg, n_fft=n_fft_d, hop=hop_d)
        recorded["mel_frontend"].clear()
        mel_kernel.KERNEL.launches = mel_kernel.DFT_KERNEL.launches = 0
        for w in wavs:
            w_pad = np.pad(w, (0, -len(w) % hop_d)).astype(np.float32)
            dsp.melspectrogram_auto(torch.from_numpy(w_pad).cuda()[None], cfg_d)
        torch.cuda.synchronize()
        launches[name] = mel_kernel.DFT_KERNEL.launches
        print(f"[{name}] dsp.melspectrogram_auto at n_fft {n_fft_d} / hop {hop_d} on the "
              f"{len(wavs)} demo wavs: DFT route launches {mel_kernel.DFT_KERNEL.launches}, FFT "
              f"route launches {mel_kernel.KERNEL.launches}")
        if mel_kernel.DFT_KERNEL.launches != len(wavs) or mel_kernel.KERNEL.launches:
            failures.append(f"[{name}] launches: DFT {mel_kernel.DFT_KERNEL.launches}, FFT "
                            f"{mel_kernel.KERNEL.launches} for {len(wavs)} wavs")
        cases = [c[0] for c in recorded["mel_frontend"]]
        (y_d, T_d, c_d), others = cases[0], cases[1:]
        B_d, Lp_d = y_d.shape
        F_d = n_fft_d // 2 + 1
        nnz_d = int(np.count_nonzero(mel_kernel.mel_filterbank(
            cfg.sample_rate, n_fft_d, cfg.n_mels, cfg.f_min, cfg.f_max)))
        win_d = torch.from_numpy(dsp.hann_window(n_fft_d)).cuda()
        basis_d = mel_kernel._device_operands(c_d, y_d.device)[1]
        check(
            name, "multi_speaker_tts_tpu/ops/mel_kernel.py:151",
            "multi_speaker_tts_tpu_torch/csrc/mel.cu",
            lambda y=y_d, t=T_d, c=c_d: mel_kernel.melspectrogram_kernel.original(y, t, c),
            lambda y=y_d, t=T_d, c=c_d: mel_kernel.melspectrogram_plain(y, t, c),
            max_abs, 1e-4,
            _bound_ms(4 * (B_d * Lp_d + nnz_d + B_d * T_d * cfg.n_mels),
                      B_d * T_d * (n_fft_d + 5 * (n_fft_d // 2) * math.log2(n_fft_d // 2)
                                   + 10 * (n_fft_d // 2) + 3 * F_d + 2 * nnz_d),
                      F32_FLOPS),
            library_fn={"stft+basis": lambda y=y_d, h=hop_d, n=n_fft_d, w=win_d, b=basis_d: (
                torch.stft(y, n, h, window=w, center=False, return_complex=True).abs()
                .transpose(-1, -2) @ b)},
            also=[(lambda y=y, t=t, c=c: mel_kernel.melspectrogram_kernel.original(y, t, c),
                   lambda y=y, t=t, c=c: mel_kernel.melspectrogram_plain(y, t, c))
                  for y, t, c in others],
            extra={"shape": [B_d, T_d, n_fft_d, hop_d],
                   "shapes_checked": [list(c[0].shape) + [c[1]] for c in cases],
                   "dft_bound_ms": _bound_ms(
                       4 * (B_d * Lp_d + 2 * n_fft_d + nnz_d + B_d * T_d * cfg.n_mels),
                       B_d * T_d * (n_fft_d + 4 * n_fft_d * F_d + 3 * F_d + 2 * nnz_d),
                       F32_FLOPS)[0],
                   "bound_note": "real-FFT work a frame at this N, as the FFT row's; "
                                 "dft_bound_ms: the direct DFT's 2 N F FMAs a frame and its "
                                 "(N, 2) table; library: torch.stft + the basis product, "
                                 "timed only"},
            queue_ahead=True,
        )

    # GE2E LSTM layer, timed at the 768-wide layers' shape (layer 1 of the
    # stack); its error also covers layer 0's (D = mel bins) shape.
    (p, x_tm, *_), _, _ = next(c for c in rec["ge2e_lstm_layer"] if c[0][1].shape[-1] != 80)
    (p0, x0, *_), _, _ = next(c for c in rec["ge2e_lstm_layer"] if c[0][1].shape[-1] == 80)
    Tl, Bl, Dl = x_tm.shape
    Hl = p.hidden_size
    lstm_lib = lstm_lib_of(p.w_hh, p.w_ih, p.b)
    check(
        "ge2e_lstm_layer", "multi_speaker_tts_tpu/ops/lstm_pallas.py:108",
        "multi_speaker_tts_tpu_torch/csrc/lstm.cu",
        lambda: lstm_kernel.lstm_seq_layer_kernel.original(p, x_tm),
        lambda: lstm_kernel.lstm_seq_layer_plain(p, x_tm, torch.bfloat16),
        max_abs, 5e-3,
        lstm_fwd_bound(p, x_tm, False),
        library_fn=cudnn_calls(lstm_lib, x_tm),
        also=[(lambda: lstm_kernel.lstm_seq_layer_kernel.original(p0, x0),
               lambda: lstm_kernel.lstm_seq_layer_plain(p0, x0, torch.bfloat16))],
        extra=step_split(Tl, Hl, lambda: lstm_kernel.lstm_seq_layer_kernel.original(p, x_tm[:1])),
    )

    # Text-encoder BiLSTM recurrence on the hoisted gates.
    (gxf, gxb, whf, whb, *_), _, _ = rec["text_encoder_bilstm"][0]
    Sb, Bb, H4 = gxf.shape
    Hb = H4 // 4
    bi_lib = birnn_lib_of(torch.nn.LSTM, whf, whb)
    gx_cat = torch.cat([gxf, gxb], dim=-1)
    check(
        "text_encoder_bilstm", "multi_speaker_tts_tpu/ops/birnn_pallas.py:161",
        "multi_speaker_tts_tpu_torch/csrc/bilstm.cu",
        lambda: birnn_kernel.bilstm_recurrence_kernel.original(gxf, gxb, whf, whb),
        lambda: birnn_kernel.bilstm_recurrence_plain(gxf, gxb, whf, whb, torch.bfloat16),
        max_abs, 5e-3,
        bilstm_bound(gxf, False),
        library_fn=cudnn_calls(bi_lib, gx_cat),
        extra={"floor_ms": floor_ms(Sb, 2, Hb)},
    )

    # CBHG BiGRU recurrence on the hoisted input gates, over the whole decode
    # bucket. The library yardstick is a bidirectional nn.GRU fed identity
    # input weights (its input is the hoisted gates).
    (ggf, ggb, gru_f, gru_b, *_), _, _ = rec["cbhg_bigru"][0]
    Tg, Bg, H3 = ggf.shape
    Hg = H3 // 3
    gru_lib = birnn_lib_of(torch.nn.GRU, gru_f.w_hh, gru_b.w_hh, (gru_f.b_hh, gru_b.b_hh))
    gg_cat = torch.cat([ggf, ggb], dim=-1)
    check(
        "cbhg_bigru", "multi_speaker_tts_tpu/ops/birnn_pallas.py:450",
        "multi_speaker_tts_tpu_torch/csrc/bigru.cu",
        lambda: birnn_kernel.bigru_recurrence_kernel.original(ggf, ggb, gru_f, gru_b),
        lambda: birnn_kernel.bigru_recurrence_plain(ggf, ggb, gru_f, gru_b, torch.bfloat16),
        max_abs, 5e-3,
        gru_bound(ggf, False),
        library_fn=cudnn_calls(gru_lib, gg_cat),
        extra={"shape": [Tg, Bg, H3], "floor_ms": gru_floor_ms(Tg, Bg, Hg)},
    )

    # Staged Griffin-Lim: (B, T, 640) bf16 magnitudes -> (B, hop * (T - 1)).
    (mag_staged, hop, n_iter, _), _, _ = rec["griffin_lim_staged"][0]
    Bg, Tg, G = mag_staged.shape

    def rel_err(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp(min=1e-9)).item()

    def gl_floor(B, T, hop, n_iter):
        """The staged kernel's sequential floor: its 2 n_iter + 1 grid barrier
        rounds alone on its own grid (csrc/barrier_floor.cu)."""
        blocks = griffin_lim_staged.kernel_blocks(B, T, hop)
        rounds = 2 * n_iter + 1
        return {"blocks": blocks, "barrier_rounds": rounds,
                "floor_ms": _time_ms(lambda: recurrence_floor.barrier_floor(
                    rounds, 1, 1, "cuda", blocks=blocks), 3, 20)}

    check(
        "griffin_lim_staged", "multi_speaker_tts_tpu/ops/griffin_lim_staged.py:254",
        "multi_speaker_tts_tpu_torch/csrc/griffin_lim.cu",
        lambda: griffin_lim_staged.griffin_lim_staged_kernel.original(mag_staged, hop, n_iter),
        lambda: griffin_lim_staged.griffin_lim_staged_plain(mag_staged, hop, n_iter,
                                                            torch.bfloat16),
        rel_err, 2e-2,
        _bound_ms(2 * Bg * Tg * G + 4 * Bg * (Tg - 1) * hop + 2 * 5 * 2 * 128 * 128,
                  (n_iter + 0.5) * Bg * Tg * 32 * 2 * 128 * 128, BF16_FLOPS),
        warmup=1, reps=5,
        extra=dict(gl_floor(Bg, Tg, hop, n_iter),
                   error_metric="max |kernel - plain| / max |plain|",
                   launches_stream=stream_res["g stream"]["launches"]["griffin_lim_staged"]),
    )

    # The momentum mode and the dense kernel. The bf16 iteration is chaotic: a
    # flipped operand rounding grows with the iterations. So each case also
    # runs the plain version on its input moved by 1e-6 (relative, seeded
    # noise), GL_PROBE_DRAWS times, and the dense cases also the plain
    # version on the CPU (the same arithmetic with its f32 sums in another
    # order, as the kernel's are: the probe of the dense card test). The
    # iteration can settle in more than one attractor: on one recorded input
    # of pass (f) 3 of these 25 probes landed ~0.24 of the peak from the
    # plain version and 22 within 0.02 (H100, 60 iterations). So the limit
    # is max(2e-2, GL_PROBE_MULTIPLE x the median probe distance), which
    # no outlier sets, and the kernel must land within it of the plain
    # version or of one of its probes: of an output the plain version
    # itself gives for the same magnitudes (``nearest_recorded_iterations``).
    # Besides, the kernel is held to its plain version at 4 iterations (2e-2
    # of the peak) and by the relative gap of spectral convergence at the
    # recorded iterations (the JAX package's 5% gate). Timed at the recorded
    # iterations.
    GL_PROBE_MULTIPLE = 4.0
    GL_PROBE_DRAWS = 24
    g_probe = torch.Generator("cuda").manual_seed(11)

    def nudged(x):
        """``x`` moved by 1e-6 of itself, elementwise (seeded)."""
        noise = torch.randn(x.shape, generator=g_probe, device=x.device)
        return x * (1.0 + 1e-6 * noise)

    gl_tol = {"rel_4_iterations": 2e-2, "sc_gap": 5e-2, "nearest_recorded_over_its_limit": 1.0}

    def gl_err(mag, n_fft, hop, short_kernel, short_plain, probe_plains):
        def err(got, ref):
            k4, p4 = short_kernel(), short_plain()
            sc_k, sc_p = sc_of(got, mag, n_fft, hop), sc_of(ref, mag, n_fft, hop)
            probes = [probe() for probe in probe_plains]
            readings = [rel_err(q, ref) for q in probes]
            limit = max(2e-2, GL_PROBE_MULTIPLE * statistics.median(readings))
            rel = rel_err(got, ref)
            nearest = min(rel, *(rel_err(got, q) for q in probes))
            return {"rel_4_iterations": rel_err(k4, p4), "sc_gap": abs(sc_k - sc_p) / sc_p,
                    "nearest_recorded_over_its_limit": nearest / limit,
                    "nearest_recorded_iterations": nearest, "rel_recorded_iterations": rel,
                    "probe_median": statistics.median(readings), "probe_max": max(readings),
                    "probe_readings_over_2e-2": sum(r > 2e-2 for r in readings)}
        return err

    gl_extra = {"error_metric": "max |kernel - plain| / max |plain| at 4 iterations; sc_gap: "
                                "relative gap of spectral convergence at the recorded "
                                "iterations; nearest_recorded_over_its_limit: the least such "
                                "distance at the recorded iterations from the kernel to the "
                                "plain version or one of its probes (its input moved by 1e-6, "
                                f"{GL_PROBE_DRAWS} seeded draws; dense cases also run on the "
                                f"CPU) over max(2e-2, {GL_PROBE_MULTIPLE} x the probes' median "
                                "distance from the plain version)"}

    # Staged momentum mode, on pass (e)'s inputs: two bf16 previous-projection
    # buffers read and written once an iteration besides the plain mode's work.
    (mag_e, hop_e, n_iter_e, mom_e), _, _ = pe["recorded"]["griffin_lim_staged"][0]
    mag_e_full = pe["recorded"]["gl_auto"][0][0][0]
    Be, Te, _ = mag_e.shape

    def staged_mom(n, mag=mag_e):
        return (lambda: griffin_lim_staged.griffin_lim_staged_kernel.original(mag, hop_e, n,
                                                                              mom_e),
                lambda: griffin_lim_staged.griffin_lim_staged_plain(mag, hop_e, n,
                                                                    torch.bfloat16, mom_e))

    # The probe moves the f32 magnitudes the vocoder was given, before their
    # bf16 rounding into the staged layout.
    mags_e_nudged = [griffin_lim_staged.staged_magnitudes(nudged(mag_e_full), torch.bfloat16)
                     for _ in range(GL_PROBE_DRAWS)]
    check(
        "griffin_lim_staged_momentum", "multi_speaker_tts_tpu/ops/griffin_lim_staged.py:254",
        "multi_speaker_tts_tpu_torch/csrc/griffin_lim.cu",
        *staged_mom(n_iter_e), gl_err(mag_e_full, 1024, hop_e, *staged_mom(4),
                                      [staged_mom(n_iter_e, m)[1] for m in mags_e_nudged]),
        gl_tol,
        _bound_ms(2 * Be * Te * G + 4 * Be * (Te - 1) * hop_e + 2 * 5 * 2 * 128 * 128,
                  (n_iter_e + 0.5) * Be * Te * 32 * 2 * 128 * 128, BF16_FLOPS),
        warmup=1, reps=5,
        extra=dict(gl_extra, **gl_floor(Be, Te, hop_e, n_iter_e), momentum=mom_e,
                   shape=[Be, Te, n_iter_e],
                   mode="momentum (TPU branch griffin_lim_staged.py:222-241)"),
    )

    # Dense Griffin-Lim: pass (f)'s inputs (B, T, Fp) f32 + Nyquist, timed
    # there; also pass (f)'s momentum call and seeded speech-like magnitudes
    # (harmonics with seeded pitch and noise) at n_fft 512 / hop 128 and
    # n_fft 2048 / hop 256, at the same B, T and iterations.
    def full_mag(mag_p, mag_ny, n_fft):
        return torch.cat([mag_p[..., :n_fft // 2], mag_ny], dim=-1)

    def dense_case(args):
        def pair(n, mags=args[:2]):
            a = (*mags, *args[2:4], n, args[5])
            return (lambda: griffin_lim_kernel.griffin_lim_dense_kernel.original(*a),
                    lambda: griffin_lim_kernel.griffin_lim_dense_plain(*a[:5], torch.bfloat16,
                                                                       a[5]))
        def on_cpu():
            return griffin_lim_kernel.griffin_lim_dense_plain(
                *(m.cpu() for m in args[:2]), *args[2:5], torch.bfloat16, args[5]).cuda()

        probes = [pair(args[4], [nudged(m) for m in args[:2]])[1]
                  for _ in range(GL_PROBE_DRAWS)] + [on_cpu]
        return (*pair(args[4]), gl_err(full_mag(args[0], args[1], args[2]), args[2], args[3],
                                       *pair(4), probes))

    dense_args = pf_plain["recorded"]["griffin_lim_dense"][0][0]
    mp, mny, n_fft_d, hop_d, n_iter_d, _ = dense_args
    Bd_, Td_, Fp_d = mp.shape
    g_dense = torch.Generator("cuda").manual_seed(7)
    also_dense = [dense_case(pf_mom["recorded"]["griffin_lim_dense"][0][0])]
    for n_fft_x, hop_x in ((512, 128), (2048, 256)):
        t = torch.arange(hop_x * (Td_ - 1), device="cuda") / hp.Sound.Sample_Rate
        f0 = 100 + 150 * torch.rand((Bd_, 1), generator=g_dense, device="cuda")
        phase = 2 * math.pi * f0 * t
        sig = sum(torch.sin(k * phase) / k for k in range(1, 16)) * (1 + 0.5 * torch.sin(6 * t))
        sig = sig + 0.05 * torch.randn(sig.shape, generator=g_dense, device="cuda")
        mag_x = dsp.stft(sig, n_fft_x, hop_x).abs()
        also_dense.append(dense_case((*griffin_lim_kernel.split_magnitude(mag_x, n_fft_x),
                                      n_fft_x, hop_x, n_iter_d, 0.0)))
    # One launch a call: the launches the kernel's library made in one call
    # (counted there after each launch call) and the wrapper's count. The
    # profiler's device events of the call are printed beside them: CUPTI
    # does not see the card in every environment, so they are no gate.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kfn_dense = dense_case(dense_args)[0]
    kfn_dense()
    torch.cuda.synchronize()
    lib0, wrap0 = griffin_lim_kernel.kernel_launch_count(), griffin_lim_kernel.KERNEL.launches
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        torch.ones(1, device="cuda").sum().item()
    with profile(activities=acts) as prof:
        kfn_dense()
        torch.cuda.synchronize()
    dense_launches = griffin_lim_kernel.kernel_launch_count() - lib0
    dense_calls = griffin_lim_kernel.KERNEL.launches - wrap0
    device_ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    profiled = sum("gl_dense_kernel" in n for n in device_ops)
    print(f"griffin_lim_dense: one call = {dense_launches} kernel launch (library count), "
          f"{dense_calls} (wrapper count); the profiler saw {profiled} of the kernel among "
          f"the call's device ops {[n[:40] for n in device_ops]}")
    if dense_launches != 1 or dense_calls != 1:
        failures.append(f"griffin_lim_dense: {dense_launches} kernel launches ({dense_calls} "
                        f"wrapper calls) in one call, not 1")
    plan_d = griffin_lim_kernel.kernel_plan(Bd_, Td_, n_fft_d, hop_d)
    rounds_d = 2 * n_iter_d + 1
    check(
        "griffin_lim_dense", "multi_speaker_tts_tpu/ops/griffin_lim_kernel.py:210",
        "multi_speaker_tts_tpu_torch/csrc/griffin_lim_dense.cu",
        *dense_case(dense_args), gl_tol,
        _bound_ms(4 * Bd_ * Td_ * (Fp_d + 1) + 2 * 2 * 2 * n_fft_d * Fp_d
                  + 4 * Bd_ * (Td_ - 1) * hop_d,
                  (2 * n_iter_d + 1) * Bd_ * Td_ * 2 * (2 * Fp_d) * n_fft_d, BF16_FLOPS),
        warmup=1, reps=5, also=also_dense,
        extra=dict(gl_extra, shape=[Bd_, Td_, n_fft_d, hop_d, n_iter_d],
                   also="momentum 0.99 (pass f); n_fft 512 / hop 128 and 2048 / hop 256, "
                        "seeded speech-like magnitudes",
                   kernel_launches_a_call=dense_launches,
                   profiler_kernel_events_a_call=profiled, plan=plan_d, barrier_rounds=rounds_d,
                   floor_ms=_time_ms(lambda: recurrence_floor.barrier_floor(
                       rounds_d, 1, 1, "cuda", blocks=plan_d["blocks"]), 3, 20),
                   ms_momentum=_time_ms(also_dense[0][0], 1, 5),
                   ms_n_fft_512_hop_128=_time_ms(also_dense[1][0], 1, 5),
                   ms_n_fft_2048_hop_256=_time_ms(also_dense[2][0], 1, 5),
                   ptxas=ptxas.get("griffin_lim_dense.cu")),
    )

    # Decode segment, both modes: the first chunk and a mid-stream chunk of
    # the pass that ran the mode (its own carry, frame and dropout masks),
    # and K = 16 at batch 8 from the zero state (the chunk of a 256-step
    # bucket). Frames and stop logits 1e-2, alignments 1e-3, and the same
    # stopped / lengths after the chunk: f32 sums in another order flip a
    # few int8 / bf16 operand roundings, which the feedback compounds.
    # The K = 16 chunk from the zero state is chaotic in bf16: a difference in
    # the f32 sums' order grows over its steps, and on the recorded input of
    # pass (b) 1e-6 nudges of the inputs move the plain version's own
    # alignments by ~1e-3 (H100). So its alignments are held as the
    # Griffin-Lim's are: the plain version also runs on its inputs moved by
    # 1e-6 (relative, seeded; every f32 input but the masks),
    # DECODE_PROBE_DRAWS times, and once on the CPU (its f32 sums in another
    # order, as the kernel's are), and the kernel must land within
    # max(1e-3, DECODE_PROBE_MULTIPLE x the probes' median distance) of the
    # plain version or of one of its probes; the main-path chunks within 1e-3
    # of the plain version. Besides, every chunk is held one step at a time:
    # the kernel on one step (K = 1) from the plain version's carry at each
    # step, within 1e-3 (``aligns_one_step``).
    threshold = float(hp.Decoder.Stop_Threshold)
    DECODE_PROBE_MULTIPLE, DECODE_PROBE_DRAWS = 4.0, 24

    def decode_plain(*a):
        return decode_kernel.decode_segment_plain.original(*a)

    def on_device(x, dev):
        """``x`` (tensors, tuples, named tuples and dicts of them) on ``dev``."""
        if torch.is_tensor(x):
            return x.to(dev)
        if isinstance(x, dict):
            return {k: on_device(v, dev) for k, v in x.items()}
        if isinstance(x, tuple):
            items = [on_device(v, dev) for v in x]
            return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
        return x

    def nudged_segment(a):
        """``a`` with every f32 tensor but the mask and the dropout masks moved
        by 1e-6 of itself."""
        def f32(x):
            return nudged(x) if torch.is_tensor(x) and x.dtype == torch.float32 else x
        bundle_, keys_, memory_, mask_, carry_, prev_, *rest = a
        carry_n = type(carry_)(*(tuple(map(f32, v)) if isinstance(v, tuple) else f32(v)
                                 for v in carry_))
        return ({k: f32(v) for k, v in bundle_.items()}, f32(keys_), f32(memory_), mask_,
                carry_n, f32(prev_), *rest)

    def one_step_aligns(a):
        """The largest distance between the kernel's alignments and the plain
        version's over ``a``'s chunk, a step at a time (K = 1) from the plain
        version's carry and frame."""
        carry_k, prev_k, worst = a[4], a[5], 0.0
        for k in range(a[8]):
            step = (*a[:4], carry_k, prev_k, *(m if m is None else m[k:k + 1] for m in a[6:8]),
                    1, *a[9:])
            p_k = decode_plain(*step)
            worst = max(worst, max_abs(decode_kernel.decode_segment_kernel.original(*step)[4],
                                       p_k[4]))
            carry_k, prev_k = p_k[0], p_k[1]
        return worst

    def decode_err(stopped, lengths, a, probed=False):
        def err(got, ref):
            s_got = decode_kernel.advance_stops(got[3], stopped, lengths, threshold)
            s_ref = decode_kernel.advance_stops(ref[3], stopped, lengths, threshold)
            same = all(torch.equal(x, y) for x, y in zip(s_got, s_ref))
            aligns = max_abs(got[4], ref[4])
            e = {"frames": max_abs(got[2], ref[2]), "aligns_nearest_over_its_limit": aligns / 1e-3,
                 "aligns_one_step": one_step_aligns(a), "stop_logits": max_abs(got[3], ref[3]),
                 "prev": max_abs(got[1], ref[1]),
                 "state": max_abs(tuple(got[0].h + got[0].c), tuple(ref[0].h + ref[0].c)),
                 "stopped_lengths_differ": 0.0 if same else 1.0, "aligns": aligns}
            if probed:
                probes = [decode_plain(*nudged_segment(a)) for _ in range(DECODE_PROBE_DRAWS)]
                probes.append(on_device(decode_plain(*on_device(a, "cpu")), ref[4].device))
                readings = [max_abs(q[4], ref[4]) for q in probes]
                limit = max(1e-3, DECODE_PROBE_MULTIPLE * statistics.median(readings))
                nearest = min(aligns, *(max_abs(got[4], q[4]) for q in probes))
                e.update({"aligns_nearest_over_its_limit": nearest / limit,
                          "aligns_nearest": nearest, "aligns_probe_median": statistics.median(
                              readings), "aligns_probe_max": max(readings),
                          "aligns_cpu": readings[-1]})

                def by_step(x):
                    return [float(f"{v:.2e}") for v in
                            (x[4].float() - ref[4].float()).abs().amax(dim=(1, 2)).tolist()]
                print(f"  K = {a[8]} chunk from the zero state, alignments' distance from the "
                      f"plain version a step: kernel {by_step(got)}; plain on the CPU "
                      f"{by_step(probes[-1])}; first nudged probe {by_step(probes[0])}")
            return e
        return err

    decode_tol = {"frames": 1e-2, "aligns_nearest_over_its_limit": 1.0, "aligns_one_step": 1e-3,
                  "stop_logits": 1e-2, "prev": 1e-2, "state": 1e-2, "stopped_lengths_differ": 0.0}
    for mode, res in (("bf16", pb), ("int8", pc)):
        name = f"decode_segment_{mode}"
        calls, segs = rec[name], res["recorded"]["segment"]
        pairs = []
        for i in (0, len(calls) // 2):
            args = calls[i][0]
            stopped, lengths = segs[i][0][7], segs[i][0][8]
            pairs.append((args, decode_err(stopped, lengths, args)))
        args0 = pairs[0][0]
        bundle, keys, memory, mask = args0[:4]
        Kd, mel_dim = args0[8], args0[9]
        Bd, Sd, _ = keys.shape
        Dd, Hd = memory.shape[-1], args0[4].h[0].shape[-1]
        P1, P2 = bundle["wp1"].shape[0], bundle["wp2"].shape[0]
        # K = 16, B = 8: the batch twice over, fresh masks from a seed.
        g = torch.Generator(keys.device).manual_seed(16)
        keys8, memory8, mask8 = keys.repeat(2, 1, 1), memory.repeat(2, 1, 1), mask.repeat(2, 1)
        masks8 = [(torch.rand((16, 2 * Bd, P), generator=g, device=keys.device) < 0.5).float() / 0.5
                  for P in (P1, P2)]
        args8 = (bundle, keys8, memory8, mask8,
                 decoder_scan.initial_carry(2 * Bd, memory8, 2, Hd),
                 torch.zeros(2 * Bd, mel_dim, device=keys.device), *masks8, 16, mel_dim, r)
        zeros8 = torch.zeros(2 * Bd, dtype=torch.bool, device=keys.device)
        pairs.append((args8, decode_err(zeros8, zeros8.to(torch.int32), args8, probed=True)))
        # B = 32, the daemon's 32-row bucket: the first chunk's batch 8 times
        # over, two row groups of 16 (two launches a chunk).
        def rep(t):
            return t.repeat(8, *([1] * (t.dim() - 1)))

        c0 = args0[4]
        args32 = (bundle, rep(keys), rep(memory), rep(mask),
                  type(c0)(tuple(map(rep, c0.h)), tuple(map(rep, c0.c)), rep(c0.weights),
                           rep(c0.cum_weights), rep(c0.context)),
                  rep(args0[5]), *(None if m is None else m.repeat(1, 8, 1) for m in args0[6:8]),
                  *args0[8:])
        pairs.append((args32, decode_err(rep(segs[0][0][7]), rep(segs[0][0][8]), args32)))

        # Pass (o)'s first chunks (from the zero state, the checkpoint's own
        # state and masks) at S 208, 1008 and the mode's one-row limit, at
        # 16 rows (the row groups the layout sizes) and at one row; the bf16
        # ones by the probe rule of the chunk from the zero state.
        def with_rows(a, B_):
            def take(t, dim=0):
                n = t.shape[dim]
                t = t.repeat(*[-(-B_ // n) if d == dim else 1 for d in range(t.dim())])
                return t.narrow(dim, 0, B_)
            c_ = a[4]
            return (a[0], take(a[1]), take(a[2]), take(a[3]),
                    type(c_)(tuple(map(take, c_.h)), tuple(map(take, c_.c)), take(c_.weights),
                             take(c_.cum_weights), take(c_.context)),
                    take(a[5]), *(None if m is None else take(m, 1) for m in a[6:8]), *a[8:])

        long_cases = [(S_o, B_o, with_rows(a_o, B_o))
                      for S_o, a_o in sorted(o_chunks.get(mode, {}).items()) for B_o in (16, 1)]

        def kernel_fn(a):
            return lambda: decode_kernel.decode_segment_kernel.original(*a)

        def plain_fn(a):
            return lambda: decode_kernel.decode_segment_plain.original(*a)

        weights = _nbytes(bundle["w0"], bundle["w1"])
        # int8 keeps both layers' rows in shared memory for the launch; bf16
        # keeps layer 0's and streams layer 1's every step.
        resident = mode == "int8"
        reread = 0 if resident else _nbytes(bundle["w1"])

        def chunk_bound(a):
            """The bound of one chunk on ``a``: every weight, input and output
            once, and the gate products."""
            B_, S_, K_ = a[1].shape[0], a[1].shape[1], a[8]
            rest = (_nbytes(*(v for k, v in bundle.items()
                              if k not in ("quantized", "w0", "w1", "packed")))
                    + _nbytes(*a[1:4], a[6], a[7], a[5], *a[4].h, *a[4].c, a[4].weights,
                              a[4].cum_weights, a[4].context))
            outputs = 4 * (K_ * B_ * (mel_dim * r + 1) + K_ * B_ * S_ + 4 * B_ * Hd
                           + 2 * B_ * S_ + B_ * Dd + B_ * mel_dim)
            flops = K_ * 2 * B_ * 4 * Hd * ((P2 + Dd + Hd) + (2 * Hd + Dd))
            return _bound_ms(weights + rest + outputs, flops,
                             INT8_OPS if resident else BF16_FLOPS)

        bound32 = chunk_bound(args32)
        # Card time (queued ahead): two launches of 16 rows, and one alone.
        ms32 = _time_ms(kernel_fn(args32), 2, 10, queue_ahead=True)
        c32 = args32[4]
        args16 = (bundle, *(t[:16] for t in args32[1:4]),
                  type(c32)(tuple(x[:16] for x in c32.h), tuple(x[:16] for x in c32.c),
                            c32.weights[:16], c32.cum_weights[:16], c32.context[:16]),
                  args32[5][:16], *(None if m is None else m[:, :16] for m in args32[6:8]),
                  *args32[8:])
        ms16 = _time_ms(kernel_fn(args16), 2, 10, queue_ahead=True)
        # The long chunks, held by the probe rule on every output: from the
        # zero state at 16 distinct rows the chunk is ill-conditioned in both
        # modes (H100: 1e-6 nudges of its inputs move the plain version's own
        # int8 stop logits by up to 1.35e-2 and its state by up to 1.6e-2
        # over K = 10 steps, beyond the 1e-2 of the short chunks). Each output
        # within max(its tolerance, DECODE_PROBE_MULTIPLE x the probes'
        # median distance) of the plain version or of one of its probes, and,
        # a step at a time from the plain version's carry, every output within
        # 1e-3 of it (``one_step``: the tight test of the kernel). Then card
        # time, launches a chunk (row groups) and bound; at S 208 also 15
        # rows, one launch fewer than 16 in bf16: the cost of the extra group
        # (the weights read again).
        def long_err(a):
            got, ref = decode_kernel.decode_segment_kernel.original(*a), decode_plain(*a)
            probes = [decode_plain(*nudged_segment(a)) for _ in range(DECODE_PROBE_DRAWS)]
            probes.append(on_device(decode_plain(*on_device(a, "cpu")), ref[4].device))
            parts = {"frames": lambda x: x[2], "stop_logits": lambda x: x[3],
                     "prev": lambda x: x[1], "state": lambda x: tuple(x[0].h + x[0].c),
                     "aligns": lambda x: x[4]}
            e = {}
            for q, part in parts.items():
                readings = [max_abs(part(p), part(ref)) for p in probes]
                limit = max(decode_tol.get(q, 1e-3), DECODE_PROBE_MULTIPLE
                            * statistics.median(readings))
                nearest = min(max_abs(part(got), part(ref)),
                              *(max_abs(part(got), part(p)) for p in probes))
                e[q] = max_abs(part(got), part(ref))
                e[f"{q}_nearest_over_its_limit"] = nearest / limit
                e[f"{q}_probe_median"] = statistics.median(readings)
            carry_k, prev_k, worst = a[4], a[5], 0.0
            for k in range(a[8]):
                step = (*a[:4], carry_k, prev_k,
                        *(m if m is None else m[k:k + 1] for m in a[6:8]), 1, *a[9:])
                p_k, g_k = decode_plain(*step), decode_kernel.decode_segment_kernel.original(*step)
                worst = max(worst, *(max_abs(part(g_k), part(p_k)) for part in parts.values()))
                carry_k, prev_k = p_k[0], p_k[1]
            e["one_step"] = worst
            return e

        long_extra = {}
        for S_o, B_o, a_l in long_cases:
            tag = f"s{S_o}_b{B_o}"
            e = long_err(a_l)
            bad = {k: v for k, v in e.items() if (k.endswith("_over_its_limit") and not v <= 1.0)
                   or (k == "one_step" and not v <= 1e-3)}
            print(f"  {name} S {S_o}, B {B_o}: {'ok' if not bad else 'FAILED'} "
                  + json.dumps({k: float(f"{v:.3g}") for k, v in e.items()}))
            if bad:
                failures.append(f"{name} S {S_o} B {B_o}: {bad}")
            long_extra[f"errors_{tag}"] = {k: e[k] for k in ("one_step", *(
                q + "_nearest_over_its_limit" for q in ("frames", "stop_logits", "state",
                                                         "aligns")))}
            long_extra[f"ms_{tag}"] = _time_ms(kernel_fn(a_l), 1, 5, queue_ahead=True)
            long_extra[f"launches_a_chunk_{tag}"] = len(decode_kernel.kernel_row_groups(
                bundle, B_o, S_o, keys.device))
            long_extra[f"bound_ms_{tag}"] = chunk_bound(a_l)[0]
            if S_o == 208 and B_o == 16:
                long_extra["ms_s208_b15"] = _time_ms(kernel_fn(with_rows(a_l, 15)), 1, 5,
                                                     queue_ahead=True)
                long_extra["launches_a_chunk_s208_b15"] = len(decode_kernel.kernel_row_groups(
                    bundle, 15, 208, keys.device))
        lay_d = decode_kernel.decode_layout(
            Hd, torch.cuda.get_device_properties(0).multi_processor_count)
        check(
            name, "multi_speaker_tts_tpu/ops/decode_pallas.py:337",
            "multi_speaker_tts_tpu_torch/csrc/decode.cu",
            kernel_fn(args0), plain_fn(args0), pairs[0][1], decode_tol, chunk_bound(args0),
            reps=10, also=[(kernel_fn(a), plain_fn(a), e) for a, e in pairs[1:]],
            extra={
                "K": Kd, "B": Bd, "S": Sd, "chunks_on_main_path": len(calls),
                # One launch a row group of at most 16 rows a chunk.
                "ms_b32": ms32, "bound_ms_b32": bound32[0], "launches_a_chunk_b32":
                    len(decode_kernel.kernel_row_groups(bundle, 32, Sd, keys.device)),
                "ms_b16": ms16,
                "weight_bytes": weights,
                "weights": ("read once per launch, then resident in shared memory" if resident
                            else "layer 0 resident in shared memory, layer 1 streamed every "
                                 "step through L2 into registers"),
                "barrier_rounds": 5 * Kd - 1, "blocks": lay_d["grid"], "threads": 512,
                "floor_ms": _time_ms(lambda: recurrence_floor.barrier_floor(
                    5 * Kd - 1, 1, 1, "cuda", blocks=lay_d["grid"], threads=512), 3, 20),
                "ptxas": ptxas.get("decode.cu"),
                # Beside bound_ms (every input once): the floor of this design,
                # which reads what it re-reads once per step.
                "reread_bytes_per_step": reread,
                "design_bound_ms": (weights + (Kd - 1) * reread) / HBM_BPS * 1e3,
                # Pass (o): S past 256 up to the one-row limit (K = 10 chunks).
                "one_row_limit_S": decode_kernel.max_positions(
                    decode_kernel.widths_of(bundle), resident,
                    *decode_kernel.card_limits(keys.device)),
                **long_extra,
            },
        )
        row = rows[-1]
        print(f"  {name}: {row['ms']:.3f} ms for K = {Kd} steps = {1e3 * row['ms'] / Kd:.1f} us "
              f"per step (floor {row['floor_ms']:.3f} ms: {row['barrier_rounds']} barrier rounds); "
              f"plain {row['plain_ms']:.2f} ms; at B 32 (two launches) {ms32:.3f} ms, bound "
              f"{bound32[0]:.4f} ms ({bound32[1]}); one launch at B 16 {ms16:.3f} ms")
        print(f"  {name} long texts (pass (o), one-row limit S {row['one_row_limit_S']}): "
              + json.dumps({k: float(f"{v:.4g}") for k, v in long_extra.items()
                            if not k.startswith("errors_")}))

    # Train phase kernels, on the inputs the last timed train step gave them:
    # the residual modes (every output against the plain version's, as a
    # share of its peak) and the backward kernels (dG, or dGx and dGh, within
    # 1e-2 of the plain version's peak). Library yardsticks: cuDNN's training
    # forward (it keeps its own reserve for the backward) and cuDNN's RNN
    # backward through torch.autograd.grad (data and weight gradients).
    launches.update(train_launches)
    n_fwd = 3  # GE2E layers a step

    def rel_peak(got, ref):
        if isinstance(got, (tuple, list)):
            return max(rel_peak(a, b) for a, b in zip(got, ref))
        return ((got.float() - ref.float()).abs().max()
                / ref.float().abs().max().clamp(min=1e-9)).item()

    def cudnn_backward(lib, x, grad_out, grad_h=None):
        """``torch.autograd.grad`` of one forward of ``lib`` (bf16) and of its
        fp16 copy, w.r.t. the input and the weights, graph retained."""
        calls = {}
        lib16 = copy.deepcopy(lib).half()
        lib16.flatten_parameters()
        for label, mod, dt in (("bf16", lib, torch.bfloat16), ("fp16", lib16, torch.float16)):
            inp = x.detach().to(dt).requires_grad_(True)
            out, hn = mod(inp)
            hn = hn[0] if isinstance(hn, tuple) else hn
            outs, grads = [out], [grad_out.to(dt)]
            if grad_h is not None:
                outs.append(hn)
                grads.append(grad_h.to(dt)[None])
            wts = list(mod.parameters())
            calls[label] = (lambda o=outs, g=grads, i=inp, w=wts:
                            torch.autograd.grad(o, [i, *w], g, retain_graph=True))
        return calls

    def res_calls(store, flag_at):
        return [c for c in store if len(c[0]) > flag_at and c[0][flag_at]]

    # GE2E layer, residual mode: timed at a 768-wide layer, layer 0 checked too.
    lres = res_calls(train_rec["ge2e_lstm_layer"], 2)[-n_fwd:]
    (p1, x1, _), _, _ = next(c for c in lres if c[0][1].shape[-1] != 80)
    (p0r, x0r, _), _, _ = next(c for c in lres if c[0][1].shape[-1] == 80)
    Tl, Bl, Dl = x1.shape
    Hl = p1.hidden_size
    check(
        "ge2e_lstm_layer_residuals", "multi_speaker_tts_tpu/ops/lstm_pallas.py:108",
        "multi_speaker_tts_tpu_torch/csrc/lstm.cu",
        lambda: lstm_kernel.lstm_seq_layer_kernel.original(p1, x1, True),
        lambda: lstm_kernel.lstm_seq_layer_plain(p1, x1, torch.bfloat16, True),
        rel_peak, 1e-2,
        lstm_fwd_bound(p1, x1, True),
        library_fn=cudnn_calls(lstm_lib, x1),
        also=[(lambda: lstm_kernel.lstm_seq_layer_kernel.original(p0r, x0r, True),
               lambda: lstm_kernel.lstm_seq_layer_plain(p0r, x0r, torch.bfloat16, True))],
        extra={"mode": "save_residuals=True (train step)", "shape": [Tl, Bl, Dl, Hl],
               **step_split(Tl, Hl, lambda: lstm_kernel.lstm_seq_layer_kernel.original(
                   p1, x1[:1], True)),
               "error_metric": "max |kernel - plain| / max |plain|, worst output"},
    )

    # GE2E layer backward: the last step's three calls (layer 2 with the
    # h_T cotangent, layers 1 and 0 with per-step cotangents); timed at
    # layer 1.
    lb = train_rec["ge2e_lstm_bwd"][-n_fwd:]
    (w_hh1, g1, c1, dh1, dys1), _, _ = lb[1]
    Tb_, Bb_, H4b = g1.shape
    Hb_ = H4b // 4

    def lstm_bwd_bytes(g, c, dh, dys):
        return (_nbytes(g, c) + 2 * g.shape[-1] * c.shape[-1] + _nbytes(g)
                + (0 if dh is None else _nbytes(dh)) + (0 if dys is None else _nbytes(dys)))

    def lstm_bwd_library(w_hh, g, dh, dys):
        """cuDNN's LSTM backward on #8's operands: identity input weights on
        the gates, the h_T and per-step cotangents (zeros where None)."""
        T_, B_, H4_ = g.shape
        return cudnn_backward(
            lstm_lib_of(w_hh), g,
            torch.zeros(T_, B_, H4_ // 4, device=g.device) if dys is None else dys,
            torch.zeros(B_, H4_ // 4, device=g.device) if dh is None else dh)

    check(
        "ge2e_lstm_bwd", "multi_speaker_tts_tpu/ops/lstm_pallas.py:227",
        "multi_speaker_tts_tpu_torch/csrc/lstm_bwd.cu",
        lambda: lstm_kernel.lstm_seq_layer_bwd_kernel.original(w_hh1, g1, c1, dh1, dys1),
        lambda: lstm_kernel.lstm_seq_layer_bwd_plain.original(w_hh1, g1, c1, dh1, dys1),
        rel_peak, 1e-2,
        _bound_ms(lstm_bwd_bytes(g1, c1, dh1, dys1), 2 * Tb_ * Bb_ * H4b * Hb_, BF16_FLOPS),
        library_fn=lstm_bwd_library(w_hh1, g1, dh1, dys1),
        also=[(lambda a=a: lstm_kernel.lstm_seq_layer_bwd_kernel.original(*a),
               lambda a=a: lstm_kernel.lstm_seq_layer_bwd_plain.original(*a))
              for a in (lb[0][0], lb[2][0])],
        extra={"shape": [Tb_, Bb_, H4b], "launches_per_step": 3,
               **step_split(Tb_, Hb_, lambda: lstm_kernel.lstm_seq_layer_bwd_kernel.original(
                   w_hh1, g1[-1:], c1[-1:], dh1, None if dys1 is None else dys1[-1:])),
               "error_metric": "max |dG - plain dG| / max |plain dG|",
               "library": "cuDNN LSTM backward (identity input weights; data and weight "
                          "gradients), the faster of bf16 and fp16"},
    )

    # BiLSTM, residual mode and backward.
    bres = res_calls(train_rec["text_encoder_bilstm"], 4)[-1]
    (bgf, bgb, bwf, bwb, _), _, _ = bres
    Sb, Bb, H4 = bgf.shape
    Hb = H4 // 4
    check(
        "text_encoder_bilstm_residuals", "multi_speaker_tts_tpu/ops/birnn_pallas.py:161",
        "multi_speaker_tts_tpu_torch/csrc/bilstm.cu",
        lambda: birnn_kernel.bilstm_recurrence_kernel.original(bgf, bgb, bwf, bwb, True),
        lambda: birnn_kernel.bilstm_recurrence_plain(bgf, bgb, bwf, bwb, torch.bfloat16, True),
        rel_peak, 1e-2,
        bilstm_bound(bgf, True),
        library_fn=cudnn_calls(bi_lib, torch.cat([bgf, bgb], dim=-1)),
        extra={"mode": "save_residuals=True (train step)", "shape": [Sb, Bb, H4],
               "floor_ms": floor_ms(Sb, 2, Hb),
               "error_metric": "max |kernel - plain| / max |plain|, worst output"},
    )
    bargs = train_rec["text_encoder_bilstm_bwd"][-1][0]
    gf_, cf_, gb_, cb_, _, _, dyf_, dyb_ = bargs
    check(
        "text_encoder_bilstm_bwd", "multi_speaker_tts_tpu/ops/birnn_pallas.py:255",
        "multi_speaker_tts_tpu_torch/csrc/bilstm_bwd.cu",
        lambda: birnn_kernel.bilstm_bwd_kernel.original(*bargs),
        lambda: birnn_kernel.bilstm_bwd_plain.original(*bargs),
        rel_peak, 1e-2,
        _bound_ms(_nbytes(gf_, cf_, gb_, cb_, dyf_, dyb_, gf_, gb_) + 2 * 2 * H4 * Hb,
                  2 * 2 * Sb * Bb * H4 * Hb, BF16_FLOPS),
        library_fn=cudnn_backward(bi_lib, torch.cat([gf_, gb_], dim=-1),
                                  torch.cat([dyf_, dyb_], dim=-1)),
        extra={"shape": [Sb, Bb, H4], "launches_per_step": 1, "floor_ms": floor_ms(Sb, 2, Hb),
               "error_metric": "max |dG - plain dG| / max |plain dG|, both directions",
               "library": "cuDNN bidirectional LSTM backward (identity input weights; data "
                          "and weight gradients), the faster of bf16 and fp16"},
    )

    # BiGRU, residual mode and backward, over the mel bucket.
    gres = res_calls(train_rec["cbhg_bigru"], 4)[-1]
    (tgf, tgb, tpf, tpb, _), _, _ = gres
    Tg, Bg, H3 = tgf.shape
    Hg = H3 // 3
    check(
        "cbhg_bigru_residuals", "multi_speaker_tts_tpu/ops/birnn_pallas.py:450",
        "multi_speaker_tts_tpu_torch/csrc/bigru.cu",
        lambda: birnn_kernel.bigru_recurrence_kernel.original(tgf, tgb, tpf, tpb, True),
        lambda: birnn_kernel.bigru_recurrence_plain(tgf, tgb, tpf, tpb, torch.bfloat16, True),
        rel_peak, 1e-2,
        gru_bound(tgf, True),
        library_fn=cudnn_calls(gru_lib, torch.cat([tgf, tgb], dim=-1)),
        extra={"mode": "save_residuals=True (train step)", "shape": [Tg, Bg, H3],
               "floor_ms": gru_floor_ms(Tg, Bg, Hg),
               "error_metric": "max |kernel - plain| / max |plain|, worst output"},
    )
    gargs = train_rec["cbhg_bigru_bwd"][-1][0]
    gxf_, ghf_, hpf_, gxb_, ghb_, hpb_, _, _, gdyf, gdyb = gargs
    check(
        "cbhg_bigru_bwd", "multi_speaker_tts_tpu/ops/birnn_pallas.py:529",
        "multi_speaker_tts_tpu_torch/csrc/bigru_bwd.cu",
        lambda: birnn_kernel.bigru_bwd_kernel.original(*gargs),
        lambda: birnn_kernel.bigru_bwd_plain.original(*gargs),
        rel_peak, 1e-2,
        _bound_ms(_nbytes(gxf_, ghf_, hpf_, gxb_, ghb_, hpb_, gdyf, gdyb)
                  + 2 * 2 * H3 * Hg + 4 * _nbytes(gxf_),
                  2 * 2 * Tg * Bg * H3 * Hg, BF16_FLOPS),
        library_fn=cudnn_backward(gru_lib, torch.cat([gxf_, gxb_], dim=-1),
                                  torch.cat([gdyf, gdyb], dim=-1)),
        extra={"shape": [Tg, Bg, H3], "launches_per_step": 1,
               "floor_ms": _time_ms(lambda: recurrence_floor.gru_chain_floor(
                   Tg, Bg, Hg, "cuda", backward=True), 3, 20),
               "error_metric": "max |dGx, dGh - plain| / max |plain|, both directions",
               "library": "cuDNN bidirectional GRU backward (identity input weights; data "
                          "and weight gradients), the faster of bf16 and fp16"},
        queue_ahead=True,
    )

    # Fused attention step (#11): the middle step of the probe's kernel loop
    # at its defaults (timed), and of the train-shape loop (checkpoint
    # weights). Gates: each output within 1e-4 of its peak for the step,
    # and the 200-step loops' outputs (phase h) within 1e-3.
    launches["attention_step"] = attn_res["probe"]["launches"]

    def attn_pair(args):
        return (lambda: attention_step_kernel.attention_step_kernel(*args),
                lambda: attention_step_kernel.attention_step_plain(*args))

    def attn_err(res):
        def err(got, ref):
            step = rel_peak3(got, ref)
            return {"step": max(step.values()), "loop": max(res["loop_err"].values()),
                    **step, **{f"{k}_loop": v for k, v in res["loop_err"].items()},
                    **{f"{k}_loop_probe": v for k, v in res["loop_probe"].items()}}
        return err

    mid = attn_res["probe"]["mid"]
    h_a, wp_a, cp_a, keys_a, mem_a, madd_a, ap_a = mid
    Ba, Sa, Aa = keys_a.shape
    Da, Ha = mem_a.shape[-1], h_a.shape[-1]
    Ka, _, Ca = ap_a.conv_kernel.shape
    attn_flops = (2 * Ba * Ha * Aa + 2 * Ba * Sa * Ca * 2 * Ka + 2 * Ba * Sa * Ca * Aa
                  + 5 * Ba * Sa * Aa + 6 * Ba * Sa + 2 * Ba * Sa * Da)
    attn_bytes = _nbytes(*mid[:6], *ap_a) + 4 * (2 * Ba * Sa + Ba * Da)
    t_mid = attn_res["train"]["mid"]
    check(
        "attention_step", "tools/attention_probe.py:62",
        "multi_speaker_tts_tpu_torch/csrc/attention_step.cu",
        *attn_pair(mid), attn_err(attn_res["probe"]), {"step": 1e-4, "loop": 1e-3},
        _bound_ms(attn_bytes, attn_flops, F32_FLOPS),
        also=[(*attn_pair(t_mid), attn_err(attn_res["train"]))],
        # A step is shorter than its host-side dispatch (phase h): time the
        # card's work alone.
        queue_ahead=True,
        extra={
            "shape": {"B": Ba, "S": Sa, "A": Aa, "D": Da, "H": Ha, "K": Ka, "C": Ca},
            "plan": attention_step_kernel.kernel_plan(
                Ba, Sa, Aa, Da, Ka, Ca, attention_step_kernel.max_clusters("cuda")),
            "max_clusters": attention_step_kernel.max_clusters("cuda"),
            "ms_host_dispatched": _time_ms(attn_pair(mid)[0], 3, 20),
            "launches_per_loop": {k: v["launches"] for k, v in attn_res.items()},
            "loop_us_per_step": {k: v["us"] for k, v in attn_res.items()},
            "loop_device_busy_us_per_step": {k: v["busy_us"] for k, v in attn_res.items()},
            "loop_device_idle": {k: v["idle"] for k, v in attn_res.items()},
            "train_case": {"shape": list(t_mid[3].shape) + [t_mid[4].shape[-1]],
                           "ms": _time_ms(attn_pair(t_mid)[0], 3, 20, True),
                           "plain_ms": _time_ms(attn_pair(t_mid)[1], 1, 5, True)},
            "error_metric": "max |kernel - plain| / max |plain|, worst of w, cum and ctx: "
                            "one step (the middle step's inputs) and after the 200-step loops",
            "bound_note": "tanh counted as one operation; in a loop keys and memory "
                          "(24.6 MB at these shapes) can stay in the 50 MB L2",
        },
    )

    # Pass (p)'s rows: the routes past the production widths, on what pass
    # (p) gave them, with ``launches`` from its main-path runs. Each held with
    # the tolerance its production row uses.
    launches.update(wide["launches"])

    def orig(fn):
        return getattr(fn, "original", fn)

    def also_times(pairs, bounds, libs=None):
        """The kernel, plain and library ms and the bound of each ``also``
        case of a row (its other shapes), timed as the row's own."""
        out = []
        for i, (k_fn, p_fn) in enumerate(pairs):
            d = {"ms": _time_ms(k_fn, 2, 10), "plain_ms": _time_ms(p_fn, 1, 2)}
            d["bound_ms"], d["bound_by"] = bounds[i]
            if libs is not None:
                d["library_ms"] = min(_time_ms(f, 2, 10) for f in libs[i].values())
            out.append(d)
        return out

    # #8 at GE2E's published batch: the middle layer's call of the (p1)
    # step (per-step cotangents), 640 rows in the kernel's row groups.
    w8, g8, c8, dh8, dys8 = wide["p1"]["args"][1]
    T8, B8, H48 = g8.shape
    H8 = H48 // 4
    check(
        "ge2e_lstm_bwd_640", "multi_speaker_tts_tpu/ops/lstm_pallas.py:227",
        "multi_speaker_tts_tpu_torch/csrc/lstm_bwd.cu",
        lambda: orig(lstm_kernel.lstm_seq_layer_bwd_kernel)(w8, g8, c8, dh8, dys8),
        lambda: orig(lstm_kernel.lstm_seq_layer_bwd_plain)(w8, g8, c8, dh8, dys8),
        rel_peak, 1e-2,
        _bound_ms(lstm_bwd_bytes(g8, c8, dh8, dys8), 2 * T8 * B8 * H48 * H8, BF16_FLOPS),
        library_fn=lstm_bwd_library(w8, g8, dh8, dys8),
        reps=5,
        extra={"shape": [T8, B8, H48], "row_groups": wide["p1"]["groups"],
               "launches_per_step": len(wide["p1"]["groups"]) * 3,
               "step_vs_plain_backward": {k: wide["p1"][k] for k in ("loss", "grad_norm", "dG8")},
               "error_metric": "max |dG - plain dG| / max |plain dG|",
               "library": "cuDNN LSTM backward (identity input weights; data and weight "
                          "gradients), the faster of bf16 and fp16"},
    )

    # The BiGRU past H 192: (p2)'s CBHG call (H 256 a direction) and its
    # train step's residual mode and backward, also at H 384, 512 and 1024
    # on seeded inputs (B 4, T 37, the narrow card tests' scale).
    def gru_case(H, B=4, T=37, seed=0):
        from multi_speaker_tts_tpu_torch.ops.gru import GRUParams

        rng_g = np.random.default_rng(seed + H)
        sc = 0.1 * (128 / H) ** 0.5

        def one():
            return GRUParams(*(torch.from_numpy((rng_g.normal(size=sh) * s_).astype(np.float32))
                               .cuda() for sh, s_ in (((128, 3 * H), 0.1), ((H, 3 * H), sc),
                                                      ((3 * H,), 0.1), ((3 * H,), 0.1))))

        pf_, pb_ = one(), one()
        x_ = torch.from_numpy(rng_g.normal(size=(B, T, 128)).astype(np.float32)).cuda()
        return (*birnn_kernel.bigru_hoist(pf_, pb_, x_, torch.bfloat16), pf_, pb_)

    def gru_lib_of(pf_, pb_):
        return birnn_lib_of(torch.nn.GRU, pf_.w_hh, pb_.w_hh, (pf_.b_hh, pb_.b_hh))

    synth_cases = {H: gru_case(H) for H in (384, 512, 1024)}
    synth_libs = [cudnn_calls(gru_lib_of(c[2], c[3]), torch.cat(c[:2], dim=-1))
                  for c in synth_cases.values()]
    pw = wide["p2"]
    for name, res in (("cbhg_bigru_wide", False), ("cbhg_bigru_wide_residuals", True)):
        a_ = (pw["bigru"] if not res else pw["bigru_res"])[0]
        gf_, gb_, pf_, pb_ = a_[:4]
        T_, B_, H3_ = gf_.shape
        lib = gru_lib_of(pf_, pb_)
        pairs = [(lambda c=c: orig(birnn_kernel.bigru_recurrence_kernel)(*c, res),
                  lambda c=c: birnn_kernel.bigru_recurrence_plain(*c, torch.bfloat16, res))
                 for c in synth_cases.values()]
        check(
            name, "multi_speaker_tts_tpu/ops/birnn_pallas.py:450",
            "multi_speaker_tts_tpu_torch/csrc/bigru_wide.cu",
            lambda a=(gf_, gb_, pf_, pb_, res): orig(birnn_kernel.bigru_recurrence_kernel)(*a),
            lambda a=(gf_, gb_, pf_, pb_): birnn_kernel.bigru_recurrence_plain(
                *a, torch.bfloat16, res),
            rel_peak if res else max_abs, 1e-2 if res else 5e-3,
            gru_bound(gf_, res),
            library_fn=cudnn_calls(lib, torch.cat([gf_, gb_], dim=-1)),
            also=pairs, reps=10,
            extra={"shape": [T_, B_, H3_], "also_H": list(synth_cases),
                   "also_times": also_times(pairs, [gru_bound(c[0], res)
                                                    for c in synth_cases.values()], synth_libs),
                   "row_groups": len(birnn_kernel.wide_row_groups(False, H3_ // 3, B_,
                                                                  _build.card_limits("cuda"))),
                   "mode": "save_residuals=True (train step)" if res else "inference",
                   "library": "cuDNN bidirectional GRU (identity input weights), the faster "
                              "of bf16 and fp16"},
        )
    def gru_bwd_bound(a):
        T_, B_, H3_ = a[0].shape
        return _bound_ms(_nbytes(*a[:6], a[8], a[9]) + 2 * 2 * H3_ * (H3_ // 3)
                         + 4 * _nbytes(a[0]), 2 * 2 * T_ * B_ * H3_ * (H3_ // 3), BF16_FLOPS)

    ba = pw["bigru_bwd"][0]
    bgx, bgh, bhp = ba[0], ba[1], ba[2]
    T_, B_, H3_ = bgx.shape
    Hb_ = H3_ // 3
    lib = gru_lib_of(*pw["bigru_res"][0][2:4])
    bwd_also, bwd_bounds, bwd_libs = [], [], []
    for c in synth_cases.values():
        ysf_, ysb_, ghf_, hpf_, ghb_, hpb_ = birnn_kernel.bigru_recurrence_kernel(*c, True)
        Hc = c[0].shape[-1] // 3
        dyc = [torch.from_numpy(np.random.default_rng(Hc + i).normal(size=(37, 4, Hc))
                                .astype(np.float32)).cuda() for i in range(2)]
        argc = (c[0], ghf_, hpf_, c[1], ghb_, hpb_, c[2].w_hh, c[3].w_hh, *dyc)
        bwd_also.append((lambda a=argc: orig(birnn_kernel.bigru_bwd_kernel)(*a),
                         lambda a=argc: orig(birnn_kernel.bigru_bwd_plain)(*a)))
        bwd_bounds.append(gru_bwd_bound(argc))
        bwd_libs.append(cudnn_backward(gru_lib_of(c[2], c[3]), torch.cat(c[:2], dim=-1),
                                       torch.cat(dyc, dim=-1)))
    check(
        "cbhg_bigru_wide_bwd", "multi_speaker_tts_tpu/ops/birnn_pallas.py:529",
        "multi_speaker_tts_tpu_torch/csrc/bigru_wide.cu",
        lambda: orig(birnn_kernel.bigru_bwd_kernel)(*ba),
        lambda: orig(birnn_kernel.bigru_bwd_plain)(*ba),
        rel_peak, 1e-2, gru_bwd_bound(ba),
        library_fn=cudnn_backward(lib, torch.cat([ba[0], ba[3]], dim=-1),
                                  torch.cat([ba[8], ba[9]], dim=-1)),
        also=bwd_also, reps=10,
        extra={"shape": [T_, B_, H3_], "also_H": list(synth_cases),
               "also_times": also_times(bwd_also, bwd_bounds, bwd_libs),
               "error_metric": "max |dGx, dGh - plain| / max |plain|, both directions",
               "library": "cuDNN bidirectional GRU backward (identity input weights; data "
                          "and weight gradients), the faster of bf16 and fp16"},
    )

    # The decode kernel past H 1024, both modes: (p2)'s first chunk (H 1536,
    # attention 640) from the zero state cut to K 4 (a K 16 chunk from the
    # zero state is chaotic in bf16, pass (b)'s rule), and seeded decoders
    # (the card tests' scale) at H 1152, 1664 and 2048 (bf16) or 2048 (int8),
    # B 1 and 16, S 64 and 208, attention 1024, K 4 each; at H 2048 layer 1's
    # gate product (4,608 deep) is staged in pieces in both modes. Frames and
    # stop logits 1e-2, alignments 1e-3. ``ms`` times the K 4 chunk; ms_chunk
    # the recorded chunk at its own K.
    def decode_err(got, ref):
        return {"aligns": max_abs(got[4], ref[4]), "frames": max_abs(got[2], ref[2]),
                "stops": max_abs(got[3], ref[3])}

    def seeded_decode(H, B, S, A, quantize, seed=11, K=4):
        from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan
        from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams

        rng_d = np.random.default_rng(seed + H + S)
        D, P, mel_, r_ = 512, 256, 80, 2

        def w(*shape, s=0.02):
            return torch.from_numpy((rng_d.standard_normal(shape) * s).astype(np.float32)).cuda()

        p_ = dscan.DecoderParams(
            lstm=(LSTMParams(w(P + D, 4 * H), w(H, 4 * H), w(4 * H)),
                  LSTMParams(w(H + D, 4 * H), w(H, 4 * H), w(4 * H))),
            attention=dscan.AttentionParams(w(H, A), w(31, 2, 32, s=0.3), w(32, A, s=0.3),
                                            w(A, 1, s=0.3)),
            frame_proj=(w(H + D, mel_ * r_), w(mel_ * r_)), stop_proj=(w(H + D, 1), w(1)))
        bundle = decode_kernel.prepare_bundle(p_, [(w(mel_, P, s=0.2), w(P)),
                                                   (w(P, P, s=0.2), w(P))], quantize=quantize)
        keys_, memory_ = w(B, S, A, s=0.3), w(B, S, D, s=0.3)
        lens = torch.tensor(([S, S - 5, 7, S] * 16)[:B], device="cuda")
        mask_ = (torch.arange(S, device="cuda")[None] < lens[:, None]).float()
        keep = [torch.from_numpy(rng_d.random((K, B, P)) < 0.5).cuda().float() / 0.5
                for _ in range(2)]
        return (bundle, keys_, memory_, mask_, dscan.initial_carry(B, memory_, 2, H),
                torch.zeros(B, mel_, device="cuda"), *keep, K, mel_, r_)

    def decode_bound(a, quantize):
        bnd, keys_r, mem_r, K_ = a[0], a[1], a[2], a[8]
        Bd, Sd, _ = keys_r.shape
        Hd = a[4].h[0].shape[-1]
        wbytes = _nbytes(bnd["w0"], bnd["w1"]) + sum(
            _nbytes(bnd[k]) for k in ("wproj", "wp1", "wp2", "wq", "wloc"))
        ops = K_ * Bd * 2 * 4 * Hd * (bnd["w0"].shape[1] + bnd["w1"].shape[1])
        return _bound_ms(wbytes + _nbytes(keys_r, mem_r) + 4 * K_ * Bd * (bnd["bproj"].numel() + Sd),
                         ops, INT8_OPS if quantize else BF16_FLOPS)

    for mode, quantize in (("bf16", False), ("int8", True)):
        rec_d = pw["decode"][mode]
        K4 = min(4, rec_d[8])
        d4 = (*rec_d[:6], *(None if m_ is None else m_[:K4] for m_ in rec_d[6:8]), K4, *rec_d[9:])
        seeded = ([(1152, 16, 208, 128), (1664, 1, 64, 128), (1152, 16, 64, 1024),
                   (2048, 16, 208, 128)] if not quantize
                  else [(2048, 16, 208, 128), (2048, 1, 64, 128), (1152, 1, 208, 1024)])
        bnd, keys_r = rec_d[0], rec_d[1]
        Bd, Sd, Ad = keys_r.shape
        Hd = rec_d[4].h[0].shape[-1]
        seeded_args = [seeded_decode(H_, B_, S_, A_, quantize) for H_, B_, S_, A_ in seeded]
        pairs = [(lambda a=a: orig(decode_kernel.decode_segment_kernel)(*a),
                  lambda a=a: orig(decode_kernel.decode_segment_plain)(*a)) for a in seeded_args]
        check(
            f"decode_segment_{mode}_wide", "multi_speaker_tts_tpu/ops/decode_pallas.py:337",
            "multi_speaker_tts_tpu_torch/csrc/decode.cu",
            lambda a=d4: orig(decode_kernel.decode_segment_kernel)(*a),
            lambda a=d4: orig(decode_kernel.decode_segment_plain)(*a),
            decode_err, {"aligns": 1e-3, "frames": 1e-2, "stops": 1e-2},
            decode_bound(d4, quantize), also=pairs, reps=10,
            extra={"shape": {"B": Bd, "S": Sd, "A": Ad, "H": Hd, "K": K4},
                   "also": [{"H": h, "B": b, "S": s_, "A": a_, "K": 4} for h, b, s_, a_ in seeded],
                   "also_times": also_times(pairs, [decode_bound(a, quantize)
                                                    for a in seeded_args]),
                   "layout": decode_kernel.layout_bytes(
                       Bd, Sd, decode_kernel.widths_of(bnd), quantize,
                       *decode_kernel.card_limits("cuda")),
                   "ms_chunk": _time_ms(lambda a=rec_d: orig(
                       decode_kernel.decode_segment_kernel)(*a), 1, 5),
                   "K_chunk": rec_d[8],
                   "bound_note": "gate weights, projection, prenet and attention weights, "
                                 "keys and memory read once; the gate products' operations"},
        )

    # The mel front-end outside 256-4096: (p3)'s calls, one row a route and
    # mode, timed at the first width; bound and library as the mel rows'.
    def mel_bound(a):
        y_, T_, c_ = a
        B_, Lp_ = y_.shape
        N_, F_ = c_.n_fft, c_.n_fft // 2 + 1
        nnz_ = int(np.count_nonzero(mel_kernel.mel_filterbank(
            c_.sample_rate, N_, c_.n_mels, c_.f_min, c_.f_max)))
        half_ = max(N_ // 2, 2)
        return _bound_ms(4 * (B_ * Lp_ + nnz_ + B_ * T_ * c_.n_mels),
                         B_ * T_ * (N_ + 5 * half_ * math.log2(half_) + 10 * half_ + 3 * F_
                                    + 2 * nnz_), F32_FLOPS)

    def mel_lib(a):
        y_, _, c_ = a
        w_ = torch.from_numpy(dsp.hann_window(c_.n_fft)).cuda()
        b_ = torch.from_numpy(mel_kernel._operands_basis(
            c_.sample_rate, c_.n_fft, c_.n_mels, c_.f_min, c_.f_max)).cuda()
        return {"stft+basis": lambda: (torch.stft(y_, c_.n_fft, c_.hop, window=w_, center=False,
                                                  return_complex=True).abs()
                                       .transpose(-1, -2) @ b_)}

    for name, cases_m in wide["mel"].items():
        (y_m, T_m, c_m), others_m = cases_m[0][:3], cases_m[1:]
        pairs_m = [(lambda a=o[:3]: orig(mel_kernel.melspectrogram_kernel)(*a),
                    lambda a=o[:3]: mel_kernel.melspectrogram_plain(*a)) for o in others_m]
        N_m = c_m.n_fft
        check(
            name, "multi_speaker_tts_tpu/ops/mel_kernel.py:151",
            "multi_speaker_tts_tpu_torch/csrc/mel.cu",
            lambda a=(y_m, T_m, c_m): orig(mel_kernel.melspectrogram_kernel)(*a),
            lambda a=(y_m, T_m, c_m): mel_kernel.melspectrogram_plain(*a),
            max_abs, 1e-4, mel_bound((y_m, T_m, c_m)),
            library_fn=mel_lib((y_m, T_m, c_m)),
            also=pairs_m, reps=10, queue_ahead=True,
            extra={"widths": [[o[2].n_fft, o[2].hop] for o in cases_m],
                   "also_times": also_times(pairs_m, [mel_bound(o[:3]) for o in others_m],
                                            [mel_lib(o[:3]) for o in others_m]),
                   "plan": list(mel_kernel.plan(N_m, _build.card_limits("cuda"))),
                   "bound_note": "real-FFT work a frame at this N, as the mel rows'"},
        )

    # Pass (q)'s rows: the LSTM family on its wide routes, on the inputs the
    # pass gave them (#2 at q2's enrollment, GE2E 1792: layer 1 timed, layer
    # 0 held; #2r and #8 at q1's 160 rows; #3, #3r and #9 at q2's encoder,
    # 1152 a direction) and on seeded inputs at 32 rows (#2 at 1152 with
    # D = H and 1664 with D 80; #3 / #3r at 1152, past the resident W_hh
    # tiles). Each with its production row's tolerance; library: cuDNN's
    # nn.LSTM at the same shapes.
    launches.update(family["launches"])

    def seeded_layer(D_, H_, B_=32, T_=64, seed=0):
        from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams

        g_ = torch.Generator(device="cuda").manual_seed(seed + H_)
        sc_ = 0.1 * (768 / H_) ** 0.5
        p_ = LSTMParams(*(torch.randn(s_, device="cuda", generator=g_) * sc_
                          for s_ in ((D_, 4 * H_), (H_, 4 * H_), (4 * H_,))))
        x_ = torch.randn(T_, B_, D_, device="cuda", generator=g_).to(torch.bfloat16)
        return p_, x_

    def seeded_bilstm(H_, B_=32, S_=64, seed=0):
        g_ = torch.Generator(device="cuda").manual_seed(seed + H_)
        sc_ = 0.1 * (256 / H_) ** 0.5
        gx_ = [(torch.randn(S_, B_, 4 * H_, device="cuda", generator=g_) * 0.5)
               .to(torch.bfloat16) for _ in range(2)]
        w_ = [torch.randn(H_, 4 * H_, device="cuda", generator=g_) * sc_ for _ in range(2)]
        return (*gx_, *w_)

    def fwd_plan(ndir, D_, H_, B_):
        r_ = lstm_kernel.fwd_rows(ndir, D_, H_, B_, _build.card_limits("cuda"))
        return {"rows": r_, **lstm_kernel.fwd_layout(ndir, D_, H_, B_, r_,
                                                     _build.card_limits("cuda"))}

    fwd_k = orig(lstm_kernel.lstm_seq_layer_kernel)
    bi_k = orig(birnn_kernel.bilstm_recurrence_kernel)

    wide_fwd_errors = []

    def wide_fwd_err(p_, x_):
        """#2's production gate, max |kernel - plain| <= 5e-3 on ys, h_T and
        c_T, widened to the plain bf16 version's own distance from its f32
        version (``drift``) where that is larger: at these widths a few bf16
        rounding flips of h grow through the recurrence, and the kernel sums
        in another order, so both are bf16 trajectories of one f32
        recurrence (tests/test_torch_cuda.py's wide cases). As a number held
        to 5e-3: ``scaled_abs`` = max |kernel - plain| x 5e-3 / max(5e-3,
        drift); and, as in the card test, every output within 1e-2 of its
        peak (``rel_peak``), a limit the data does not set. Each case's
        readings (drift and the raw distance too) go to
        ``wide_fwd_errors``."""
        ref32 = lstm_kernel.lstm_seq_layer_plain(p_, x_, torch.float32)
        ref16 = lstm_kernel.lstm_seq_layer_plain(p_, x_, torch.bfloat16)
        drift = max_abs(tuple(ref16[:3]), tuple(ref32))

        def err(got, ref):
            raw = max_abs(tuple(got[:3]), tuple(ref[:3]))
            e = {"scaled_abs": raw * 5e-3 / max(5e-3, drift),
                 "rel_peak": rel_peak(tuple(got[:3]), tuple(ref[:3])),
                 "max_abs": raw, "drift": drift}
            wide_fwd_errors.append({"shape": list(x_.shape) + [p_.hidden_size], **e})
            return e
        return err

    # #2 (inference) at q2's enrollment and seeded 1152 / 1664 (D 80).
    q2e = family["q2"]["enroll"]
    (pe1, xe1, *_) = next(a for a in q2e if a[1].shape[-1] != 80)
    (pe0, xe0, *_) = next(a for a in q2e if a[1].shape[-1] == 80)
    seeded2 = [seeded_layer(1152, 1152), seeded_layer(80, 1664)]
    pairs2 = [(lambda a=a: fwd_k(*a),
               lambda a=a: lstm_kernel.lstm_seq_layer_plain(*a, torch.bfloat16),
               wide_fwd_err(*a)) for a in ((pe0, xe0), *seeded2)]
    check(
        "ge2e_lstm_layer_wide", "multi_speaker_tts_tpu/ops/lstm_pallas.py:108",
        "multi_speaker_tts_tpu_torch/csrc/lstm.cu",
        lambda: fwd_k(pe1, xe1), lambda: lstm_kernel.lstm_seq_layer_plain(pe1, xe1,
                                                                          torch.bfloat16),
        wide_fwd_err(pe1, xe1), {"scaled_abs": 5e-3, "rel_peak": 1e-2},
        lstm_fwd_bound(pe1, xe1, False),
        library_fn=cudnn_calls(lstm_lib_of(pe1.w_hh, pe1.w_ih, pe1.b), xe1),
        also=pairs2, reps=10,
        extra={"shape": list(xe1.shape) + [pe1.hidden_size],
               "plan": fwd_plan(1, xe1.shape[-1], pe1.hidden_size, xe1.shape[1]),
               "also_shapes": [list(a[1].shape) + [a[0].hidden_size]
                               for a in ((pe0, xe0), *seeded2)],
               "also_plans": [fwd_plan(1, a[1].shape[-1], a[0].hidden_size, a[1].shape[1])
                              for a in ((pe0, xe0), *seeded2)],
               "also_times": also_times([c[:2] for c in pairs2],
                                        [lstm_fwd_bound(*a, False) for a in ((pe0, xe0),
                                                                             *seeded2)]),
               "floor_ms": floor_ms(xe1.shape[0], 1, pe1.hidden_size),
               "per_shape_errors": wide_fwd_errors,
               "error_metric": "scaled_abs: max |kernel - plain| x 5e-3 / max(5e-3, drift), "
                               "drift = max |plain bf16 - plain f32|; rel_peak: max |kernel - "
                               "plain| / max |plain|; each the worst of ys, h_T, c_T"},
    )
    # #2r at q1's 160 rows (layer 1 timed, layer 0 held), seeded 1152 too.
    q1f = family["q1"]["fwd"]
    (pr1, xr1, _) = next(a for a in q1f if a[1].shape[-1] != 80)
    (pr0, xr0, _) = next(a for a in q1f if a[1].shape[-1] == 80)
    pairs2r = [(lambda a=(pr0, xr0): fwd_k(*a, True),
                lambda a=(pr0, xr0): lstm_kernel.lstm_seq_layer_plain(*a, torch.bfloat16, True)),
               (lambda a=seeded2[0]: fwd_k(*a, True),
                lambda a=seeded2[0]: lstm_kernel.lstm_seq_layer_plain(*a, torch.bfloat16, True))]
    check(
        "ge2e_lstm_layer_residuals_wide", "multi_speaker_tts_tpu/ops/lstm_pallas.py:108",
        "multi_speaker_tts_tpu_torch/csrc/lstm.cu",
        lambda: fwd_k(pr1, xr1, True),
        lambda: lstm_kernel.lstm_seq_layer_plain(pr1, xr1, torch.bfloat16, True),
        rel_peak, 1e-2, lstm_fwd_bound(pr1, xr1, True),
        library_fn=cudnn_calls(lstm_lib_of(pr1.w_hh, pr1.w_ih, pr1.b), xr1),
        also=pairs2r, reps=5,
        extra={"mode": "save_residuals=True (q1's GE2E step)",
               "shape": list(xr1.shape) + [pr1.hidden_size],
               "plan": fwd_plan(1, xr1.shape[-1], pr1.hidden_size, xr1.shape[1]),
               "launches_per_step": launches["ge2e_lstm_layer_residuals_wide"],
               "also_times": also_times(pairs2r, [lstm_fwd_bound(pr0, xr0, True),
                                                  lstm_fwd_bound(*seeded2[0], True)]),
               "floor_ms": floor_ms(xr1.shape[0], 1, pr1.hidden_size),
               "error_metric": "max |kernel - plain| / max |plain|, worst output"},
    )
    # #8 at q1's 160 rows (layer 1, per-step cotangents).
    wq8, gq8, cq8, dhq8, dysq8 = family["q1"]["bwd"][1]
    Tq8, Bq8, H4q8 = gq8.shape
    Hq8 = H4q8 // 4
    check(
        "ge2e_lstm_bwd_wide", "multi_speaker_tts_tpu/ops/lstm_pallas.py:227",
        "multi_speaker_tts_tpu_torch/csrc/lstm_bwd.cu",
        lambda: orig(lstm_kernel.lstm_seq_layer_bwd_kernel)(wq8, gq8, cq8, dhq8, dysq8),
        lambda: orig(lstm_kernel.lstm_seq_layer_bwd_plain)(wq8, gq8, cq8, dhq8, dysq8),
        rel_peak, 1e-2,
        _bound_ms(lstm_bwd_bytes(gq8, cq8, dhq8, dysq8), 2 * Tq8 * Bq8 * H4q8 * Hq8, BF16_FLOPS),
        library_fn=lstm_bwd_library(wq8, gq8, dhq8, dysq8),
        reps=5,
        extra={"shape": [Tq8, Bq8, H4q8], "plan": family["q1"]["plan"]["bwd_layout"],
               "launches_per_step": launches["ge2e_lstm_bwd_wide"],
               "step_vs_plain_backward": {k: family["q1"][k] for k in ("loss", "grad_norm",
                                                                        "dG8")},
               "floor_ms": floor_ms(Tq8, 1, Hq8),
               "error_metric": "max |dG - plain dG| / max |plain dG|",
               "library": "cuDNN LSTM backward (identity input weights; data and weight "
                          "gradients), the faster of bf16 and fp16"},
    )
    # #3 at q2's encoder (1152 a direction), seeded at 32 rows too.
    (q3gf, q3gb, q3wf, q3wb, *_) = family["q2"]["bilstm"][0]
    seeded3 = seeded_bilstm(1152)
    pairs3 = [(lambda: bi_k(*seeded3),
               lambda: birnn_kernel.bilstm_recurrence_plain(*seeded3, torch.bfloat16))]
    check(
        "text_encoder_bilstm_wide", "multi_speaker_tts_tpu/ops/birnn_pallas.py:161",
        "multi_speaker_tts_tpu_torch/csrc/bilstm.cu",
        lambda: bi_k(q3gf, q3gb, q3wf, q3wb),
        lambda: birnn_kernel.bilstm_recurrence_plain(q3gf, q3gb, q3wf, q3wb, torch.bfloat16),
        max_abs, 5e-3, bilstm_bound(q3gf, False),
        library_fn=cudnn_calls(birnn_lib_of(torch.nn.LSTM, q3wf, q3wb), torch.cat([q3gf, q3gb], dim=-1)),
        also=pairs3, reps=10,
        extra={"shape": list(q3gf.shape), "plan": fwd_plan(2, 0, q3gf.shape[-1] // 4,
                                                            q3gf.shape[1]),
               "also_plans": [fwd_plan(2, 0, 1152, 32)],
               "also_times": also_times(pairs3, [bilstm_bound(seeded3[0], False)],
                                        [cudnn_calls(birnn_lib_of(torch.nn.LSTM, *seeded3[2:]),
                                                     torch.cat(seeded3[:2], dim=-1))]),
               "floor_ms": floor_ms(q3gf.shape[0], 2, q3gf.shape[-1] // 4)},
    )
    # #3r at q2's train step (8 rows), seeded at 32 rows too.
    (r3gf, r3gb, r3wf, r3wb, _) = family["q2"]["bilstm_res"][0]
    pairs3r = [(lambda: bi_k(*seeded3, True),
                lambda: birnn_kernel.bilstm_recurrence_plain(*seeded3, torch.bfloat16, True))]
    check(
        "text_encoder_bilstm_residuals_wide", "multi_speaker_tts_tpu/ops/birnn_pallas.py:161",
        "multi_speaker_tts_tpu_torch/csrc/bilstm.cu",
        lambda: bi_k(r3gf, r3gb, r3wf, r3wb, True),
        lambda: birnn_kernel.bilstm_recurrence_plain(r3gf, r3gb, r3wf, r3wb, torch.bfloat16,
                                                     True),
        rel_peak, 1e-2, bilstm_bound(r3gf, True),
        library_fn=cudnn_calls(birnn_lib_of(torch.nn.LSTM, r3wf, r3wb), torch.cat([r3gf, r3gb], dim=-1)),
        also=pairs3r, reps=10,
        extra={"mode": "save_residuals=True (q2's train step)", "shape": list(r3gf.shape),
               "plan": fwd_plan(2, 0, r3gf.shape[-1] // 4, r3gf.shape[1]),
               "also_times": also_times(pairs3r, [bilstm_bound(seeded3[0], True)]),
               "floor_ms": floor_ms(r3gf.shape[0], 2, r3gf.shape[-1] // 4),
               "error_metric": "max |kernel - plain| / max |plain|, worst output"},
    )
    # #9 at q2's train step (8 rows, 1152 a direction).
    bargs9 = family["q2"]["bilstm_bwd"][0]
    gf9, cf9, gb9, cb9, wf9, wb9, dyf9, dyb9 = bargs9
    S9, B9, H49 = gf9.shape
    H9 = H49 // 4
    check(
        "text_encoder_bilstm_bwd_wide", "multi_speaker_tts_tpu/ops/birnn_pallas.py:255",
        "multi_speaker_tts_tpu_torch/csrc/bilstm_bwd.cu",
        lambda: orig(birnn_kernel.bilstm_bwd_kernel)(*bargs9),
        lambda: orig(birnn_kernel.bilstm_bwd_plain)(*bargs9),
        rel_peak, 1e-2,
        _bound_ms(_nbytes(gf9, cf9, gb9, cb9, dyf9, dyb9, gf9, gb9) + 2 * 2 * H49 * H9,
                  2 * 2 * S9 * B9 * H49 * H9, BF16_FLOPS),
        library_fn=cudnn_backward(birnn_lib_of(torch.nn.LSTM, wf9, wb9), torch.cat([gf9, gb9], dim=-1),
                                  torch.cat([dyf9, dyb9], dim=-1)),
        reps=10,
        extra={"shape": [S9, B9, H49],
               "plan": lstm_kernel.bwd_layout(2, H9, B9, lstm_kernel.bwd_rows(
                   2, H9, B9, _build.card_limits("cuda")), _build.card_limits("cuda")),
               "floor_ms": floor_ms(S9, 2, H9),
               "error_metric": "max |dG - plain dG| / max |plain dG|, both directions",
               "library": "cuDNN bidirectional LSTM backward (identity input weights; data "
                          "and weight gradients), the faster of bf16 and fp16"},
    )

    # Pass (r)'s rows: the shapes past the kernels' old limits, on what the
    # pass gave them, with ``launches`` from its main-path runs, and seeded
    # shapes beside them (in ``also_times``). Each held with its production
    # row's tolerance.
    launches.update(refs["launches"])

    # #6 int8 past H 2048: (r1)'s first chunk (H 3072, six m-tiles in two
    # passes) from the zero state cut to K 4, and seeded decoders at H 2176
    # (B 16, S 208), 3072 (B 1, S 256, attention 640) and 4096 (B 4, S 64).
    def seeded_decode_cuda(H, B, S, A, seed=17, K=4):
        """:func:`seeded_decode`'s decoder, drawn on the card (a seeded
        torch generator): at these widths numpy's draws take seconds."""
        from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan
        from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams

        g_ = torch.Generator(device="cuda").manual_seed(seed + H + S)
        D, P, mel_, r_ = 512, 256, 80, 2

        def w(*shape, s=0.02):
            return torch.randn(shape, generator=g_, device="cuda") * s

        p_ = dscan.DecoderParams(
            lstm=(LSTMParams(w(P + D, 4 * H), w(H, 4 * H), w(4 * H)),
                  LSTMParams(w(H + D, 4 * H), w(H, 4 * H), w(4 * H))),
            attention=dscan.AttentionParams(w(H, A), w(31, 2, 32, s=0.3), w(32, A, s=0.3),
                                            w(A, 1, s=0.3)),
            frame_proj=(w(H + D, mel_ * r_), w(mel_ * r_)), stop_proj=(w(H + D, 1), w(1)))
        bundle = decode_kernel.prepare_bundle(p_, [(w(mel_, P, s=0.2), w(P)),
                                                   (w(P, P, s=0.2), w(P))], quantize=True)
        keys_, memory_ = w(B, S, A, s=0.3), w(B, S, D, s=0.3)
        lens = torch.tensor(([S, S - 5, 7, S] * 16)[:B], device="cuda")
        mask_ = (torch.arange(S, device="cuda")[None] < lens[:, None]).float()
        keep = [(torch.rand((K, B, P), generator=g_, device="cuda") < 0.5).float() / 0.5
                for _ in range(2)]
        return (bundle, keys_, memory_, mask_, dscan.initial_carry(B, memory_, 2, H),
                torch.zeros(B, mel_, device="cuda"), *keep, K, mel_, r_)

    rec_r1 = refs["r1"]
    K4 = min(4, rec_r1[8])
    r1_4 = (*rec_r1[:6], *(None if m_ is None else m_[:K4] for m_ in rec_r1[6:8]), K4,
            *rec_r1[9:])
    seeded_r1 = [(2176, 16, 208, 128), (3072, 1, 256, 640), (4096, 4, 64, 128)]
    seeded_r1_args = [seeded_decode_cuda(*c) for c in seeded_r1]
    pairs_r1 = [(lambda a=a: orig(decode_kernel.decode_segment_kernel)(*a),
                 lambda a=a: orig(decode_kernel.decode_segment_plain)(*a))
                for a in seeded_r1_args]
    B_r1, S_r1, A_r1 = rec_r1[1].shape
    H_r1 = rec_r1[4].h[0].shape[-1]
    check(
        "decode_segment_int8_past_2048", "multi_speaker_tts_tpu/ops/decode_pallas.py:337",
        "multi_speaker_tts_tpu_torch/csrc/decode.cu",
        lambda a=r1_4: orig(decode_kernel.decode_segment_kernel)(*a),
        lambda a=r1_4: orig(decode_kernel.decode_segment_plain)(*a),
        decode_err, {"aligns": 1e-3, "frames": 1e-2, "stops": 1e-2},
        decode_bound(r1_4, True), also=pairs_r1, reps=10,
        extra={"shape": {"B": B_r1, "S": S_r1, "A": A_r1, "H": H_r1, "K": K4},
               "also": [{"H": h, "B": b, "S": s_, "A": a_, "K": 4} for h, b, s_, a_ in seeded_r1],
               "also_times": also_times(pairs_r1, [decode_bound(a, True)
                                                   for a in seeded_r1_args]),
               "grid": decode_kernel.decode_layout(H_r1, _build.card_limits("cuda")[0]),
               "layout": decode_kernel.layout_bytes(
                   B_r1, S_r1, decode_kernel.widths_of(rec_r1[0]), True,
                   *decode_kernel.card_limits("cuda")),
               "ms_chunk": _time_ms(lambda a=rec_r1: orig(
                   decode_kernel.decode_segment_kernel)(*a), 1, 3),
               "K_chunk": rec_r1[8],
               "bound_note": "int8 gate weights (past L2), projection, prenet and attention "
                             "weights, keys and memory read once; the gate products' operations"},
    )
    del seeded_r1_args, pairs_r1

    # #5 / #5r / #10 past H 1,248: (r2)'s CBHG calls (1280 a direction) on
    # the streamed build, and seeded H 2048 and 4096 (B 4, T 37).
    r2 = refs["r2"]
    stream_cases = {H: gru_case(H) for H in (2048, 4096)}
    stream_libs = [cudnn_calls(gru_lib_of(c[2], c[3]), torch.cat(c[:2], dim=-1))
                   for c in stream_cases.values()]
    for name, res in (("cbhg_bigru_streamed", False), ("cbhg_bigru_streamed_residuals", True)):
        a_ = (r2["fwd"] if not res else r2["res"])[0]
        gf_, gb_, pf_, pb_ = a_[:4]
        T_, B_, H3_ = gf_.shape
        pairs = [(lambda c=c: orig(birnn_kernel.bigru_recurrence_kernel)(*c, res),
                  lambda c=c: birnn_kernel.bigru_recurrence_plain(*c, torch.bfloat16, res))
                 for c in stream_cases.values()]
        check(
            name, "multi_speaker_tts_tpu/ops/birnn_pallas.py:450",
            "multi_speaker_tts_tpu_torch/csrc/bigru_wide.cu",
            lambda a=(gf_, gb_, pf_, pb_, res): orig(birnn_kernel.bigru_recurrence_kernel)(*a),
            lambda a=(gf_, gb_, pf_, pb_): birnn_kernel.bigru_recurrence_plain(
                *a, torch.bfloat16, res),
            rel_peak if res else max_abs, 1e-2 if res else 5e-3,
            gru_bound(gf_, res),
            library_fn=cudnn_calls(gru_lib_of(pf_, pb_), torch.cat([gf_, gb_], dim=-1)),
            also=pairs, reps=5,
            extra={"shape": [T_, B_, H3_], "also_H": list(stream_cases),
                   "also_times": also_times(pairs, [gru_bound(c[0], res)
                                                    for c in stream_cases.values()],
                                            stream_libs),
                   "layout": birnn_kernel.wide_layout(False, H3_ // 3, B_,
                                                      _build.card_limits("cuda")),
                   "also_layouts": [birnn_kernel.wide_layout(False, H, 4,
                                                             _build.card_limits("cuda"))
                                    for H in stream_cases],
                   "mode": "save_residuals=True (r2's train step)" if res else "inference",
                   "library": "cuDNN bidirectional GRU (identity input weights), the faster "
                              "of bf16 and fp16"},
        )
    bs_ = r2["bwd"][0]
    T_, B_, H3_ = bs_[0].shape
    sbwd_also, sbwd_bounds, sbwd_libs = [], [], []
    for c in stream_cases.values():
        ysf_, ysb_, ghf_, hpf_, ghb_, hpb_ = birnn_kernel.bigru_recurrence_kernel(*c, True)
        Hc = c[0].shape[-1] // 3
        dyc = [torch.randn((37, 4, Hc), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(Hc + i))
               for i in range(2)]
        argc = (c[0], ghf_, hpf_, c[1], ghb_, hpb_, c[2].w_hh, c[3].w_hh, *dyc)
        sbwd_also.append((lambda a=argc: orig(birnn_kernel.bigru_bwd_kernel)(*a),
                          lambda a=argc: orig(birnn_kernel.bigru_bwd_plain)(*a)))
        sbwd_bounds.append(gru_bwd_bound(argc))
        sbwd_libs.append(cudnn_backward(gru_lib_of(c[2], c[3]), torch.cat(c[:2], dim=-1),
                                        torch.cat(dyc, dim=-1)))
    check(
        "cbhg_bigru_streamed_bwd", "multi_speaker_tts_tpu/ops/birnn_pallas.py:529",
        "multi_speaker_tts_tpu_torch/csrc/bigru_wide.cu",
        lambda: orig(birnn_kernel.bigru_bwd_kernel)(*bs_),
        lambda: orig(birnn_kernel.bigru_bwd_plain)(*bs_),
        rel_peak, 1e-2, gru_bwd_bound(bs_),
        library_fn=cudnn_backward(gru_lib_of(*r2["res"][0][2:4]),
                                  torch.cat([bs_[0], bs_[3]], dim=-1),
                                  torch.cat([bs_[8], bs_[9]], dim=-1)),
        also=sbwd_also, reps=5,
        extra={"shape": [T_, B_, H3_], "also_H": list(stream_cases),
               "also_times": also_times(sbwd_also, sbwd_bounds, sbwd_libs),
               "layout": birnn_kernel.wide_layout(True, H3_ // 3, B_,
                                                  _build.card_limits("cuda")),
               "step_vs_plain_backward": {k: r2[k] for k in ("loss", "grad_norm", "dG8")},
               "error_metric": "max |dGx, dGh - plain| / max |plain|, both directions",
               "library": "cuDNN bidirectional GRU backward (identity input weights; data "
                          "and weight gradients), the faster of bf16 and fp16"},
    )
    del stream_cases, stream_libs, sbwd_also, sbwd_libs

    # #7 past n_fft 2048: (r3)'s 16384 / 2048 call (T 79) timed, its 4096 /
    # 512 call (T 304) and seeded magnitudes at 2304 / 1152 (T 128), 8192 /
    # 4096 (T 157: a frame's columns in two pieces) and 32768 / 4096 (T 40:
    # 512 column slices over 132 blocks) beside it, B 1, R3_ITERS iterations,
    # the probe rule of the dense rows with the probes on the card only (the
    # CPU's plain version would build its float64 matrices, gigabytes past
    # n_fft 8192).
    def dense_case_wide(args):
        def pair(n, mags=args[:2]):
            a = (*mags, *args[2:4], n, args[5])
            return (lambda: griffin_lim_kernel.griffin_lim_dense_kernel.original(*a),
                    lambda: griffin_lim_kernel.griffin_lim_dense_plain(*a[:5], torch.bfloat16,
                                                                       a[5]))

        probes = [pair(args[4], [nudged(m) for m in args[:2]])[1]
                  for _ in range(GL_PROBE_DRAWS)]
        return (*pair(args[4]), gl_err(full_mag(args[0], args[1], args[2]), args[2], args[3],
                                       *pair(4), probes))

    def dense_bound(args):
        mp_, _, n_, h_, it_, _ = args
        B_g, T_g, Fp_g = mp_.shape
        return _bound_ms(4 * B_g * T_g * (Fp_g + 1) + 2 * 2 * 2 * n_ * Fp_g
                         + 4 * B_g * (T_g - 1) * h_,
                         (2 * it_ + 1) * B_g * T_g * 2 * (2 * Fp_g) * n_, BF16_FLOPS)

    g_wide = torch.Generator("cuda").manual_seed(2304)
    r3_16k, r3_4k = refs["r3"][1], refs["r3"][0]
    seeded_gl = []
    for n_fft_x, hop_x, T_x in ((2304, 1152, 128), (8192, 4096, 157), (32768, 4096, 40)):
        mag_x = torch.rand((1, T_x, n_fft_x // 2 + 1), generator=g_wide, device="cuda") ** 2
        seeded_gl.append((*griffin_lim_kernel.split_magnitude(mag_x, n_fft_x), n_fft_x, hop_x,
                          R3_ITERS, 0.0))
    also_gl = [dense_case_wide(a) for a in (r3_4k, *seeded_gl)]
    check(
        "griffin_lim_dense_wide", "multi_speaker_tts_tpu/ops/griffin_lim_kernel.py:210",
        "multi_speaker_tts_tpu_torch/csrc/griffin_lim_dense.cu",
        *dense_case_wide(r3_16k), gl_tol, dense_bound(r3_16k),
        warmup=1, reps=5, also=also_gl,
        extra=dict(gl_extra, shape=[1, r3_16k[0].shape[1], 16384, 2048, R3_ITERS],
                   also=[[a[2], a[3], a[0].shape[1]] for a in (r3_4k, *seeded_gl)],
                   also_times=also_times([c[:2] for c in also_gl],
                                         [dense_bound(a) for a in (r3_4k, *seeded_gl)]),
                   plans=[griffin_lim_kernel.kernel_plan(1, a[0].shape[1], a[2], a[3])
                          for a in (r3_16k, r3_4k, *seeded_gl)],
                   probes="on the card only", matrix_bytes_16384=4 * 16384 * 8192 * 2,
                   bound_note="inputs, matrices and output read or written once a call; "
                              "the kernel reads the matrices every iteration"),
    )
    del also_gl, seeded_gl
    griffin_lim_kernel._operands.cache_clear()
    griffin_lim_kernel._packed.cache_clear()
    torch.cuda.empty_cache()

    # #12: the HiFi-GAN MRF (no TPU counterpart: the JAX package has no
    # generator), pass (s)'s inputs at the 32 x 400-frame bucket: stage 3's
    # MRF timed (C 32, L 102400: the largest), stages 0-2 beside it. Each
    # against the same 18 launches through the plain convolution (f32 sums of
    # the rounded operands, the same epilogue), with cuDNN's bf16 MRF of the
    # plain route as the library yardstick. A launch differs from its plain
    # version only in the order of its f32 sums; a wrong tap, bias, residual
    # or mean moves the output by a share of its peak.
    from multi_speaker_tts_tpu_torch.models import hifigan
    from multi_speaker_tts_tpu_torch.ops import hifigan_mrf

    def mrf_plain_launches(blocks, x):
        saved = hifigan_mrf.conv
        hifigan_mrf.conv = hifigan_mrf.conv_plain
        try:
            return hifigan_mrf.mrf(blocks, x)
        finally:
            hifigan_mrf.conv = saved

    def mrf_case(st):
        return (lambda: hifigan_mrf.mrf(st["blocks"], st["x"]),
                lambda: mrf_plain_launches(st["blocks"], st["x"]))

    def mrf_bound(st):
        """The MRF's f32 input read and its mean written once, the weights
        once; 2 operations a MAC over every tap of both convolutions."""
        B_, L_, C_ = st["x"].shape
        taps = sum(b.kernel_size * len(b.dilations) for b in st["blocks"])
        n_params = sum(p.numel() for b in st["blocks"] for p in b.parameters())
        return _bound_ms(8 * B_ * L_ * C_ + 2 * n_params, 2 * 2 * B_ * L_ * C_ * C_ * taps,
                         BF16_FLOPS)

    def mrf_library(st):
        xb = st["x"].transpose(1, 2).contiguous()  # the plain route's (B, C, L)
        return {"cudnn_bf16": lambda: hifigan.plain_mrf(st["blocks"], xb, torch.bfloat16)}

    launches["hifigan_mrf"] = hifi["launches"]["conv"]
    timed, others = hifi["stages"][-1], hifi["stages"][:-1]
    with torch.no_grad():
        also_mrf = [mrf_case(st) for st in others]
        x3 = timed["x"]
        check(
            "hifigan_mrf", "none (the JAX package has no generator)",
            "multi_speaker_tts_tpu_torch/csrc/hifigan_mrf.cu",
            *mrf_case(timed), rel_peak, HIFIGAN_MRF_TOL, mrf_bound(timed),
            library_fn=mrf_library(timed), warmup=2, reps=10, also=also_mrf,
            extra={"shape": list(x3.shape), "also_shapes": [list(st["x"].shape) for st in others],
                   "also_times": also_times(also_mrf, [mrf_bound(st) for st in others],
                                            [mrf_library(st) for st in others]),
                   "launches_a_call": 18, "main_path_calls": hifi["calls"],
                   "pointwise_launches": hifi["launches"]["pointwise"],
                   "activation_ms": _time_ms(lambda: hifigan_mrf.activation(x3, 0.1), 3, 20),
                   "forward_ms": _time_ms(lambda: hifi["gen"](hifi["mel"]), 1, 3),
                   "error_metric": "max |MRF mean - plain| / max |plain|, each stage",
                   "library": "cuDNN's bf16 convolutions of the generator's plain MRF, with "
                              "their bias, cast, activation and residual passes"},
        )
    del hifi, timed, others, also_mrf, x3
    torch.cuda.empty_cache()

    # 4. Report --------------------------------------------------------------
    print(f"[time] the kernel phase took {time.perf_counter() - t_kernels:.1f} s")
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
