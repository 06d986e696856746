"""Routing as the reference routes, and the LSTM family at every width the
JAX gate admits, on the CPU.

- Where the port's kernel refuses and the JAX package's gate refuses too,
  the port runs the plain version on the tensors' device with one
  ``[dispatch]`` line; where the JAX gate launches its kernel, the port's
  wrapper launches or raises. Each route is held against the JAX package's
  own decision over a grid: the Griffin-Lim route against
  ``_pallas_gl_max_batch`` and ``griffin_lim_auto``'s rule, the decode
  route against ``decode_pallas.supported``, the recurrence routes against
  ``lstm_pallas.supported`` / ``birnn_pallas.supported``; and wherever the
  JAX gate launches, the port's kernel takes the shape: the int8 decode to
  H 8192, the BiGRU to 4096, the dense Griffin-Lim to n_fft 65536.
- The LSTM forward's and backward's launch plans at H100 constants take at
  least one row at every H % 128 up to 4096, keep the production layouts,
  and the forward's wrapper calls its entry point once a row group.
- The CLIs' ``-hp`` and the training CLI's ``-debug_nans``.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import json
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.ops import birnn_pallas, lstm_pallas
from multi_speaker_tts_tpu.ops import decode_pallas as jdk
from multi_speaker_tts_tpu.ops import decoder_scan as jdscan
from multi_speaker_tts_tpu.ops.lstm import LSTMParams as JaxLSTMParams
from multi_speaker_tts_tpu.ops.stft_matmul import _pallas_gl_max_batch
from multi_speaker_tts_tpu_torch import inference, serve
from multi_speaker_tts_tpu_torch.audio import dsp
from multi_speaker_tts_tpu_torch.data.pattern_generator import generate_synthetic_dataset
from multi_speaker_tts_tpu_torch.hparams import tiny_test_hparams
from multi_speaker_tts_tpu_torch.ops import _build, birnn_kernel, gru, lstm_kernel, stft_matmul
from multi_speaker_tts_tpu_torch.ops import griffin_lim_kernel as gk
from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk
from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan
from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams, bilstm_fused, lstm_stack
from multi_speaker_tts_tpu_torch.train import __main__ as train_cli
from multi_speaker_tts_tpu_torch.train import debug_nans
from multi_speaker_tts_tpu_torch.train.ge2e_trainer import GE2ETrainer

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_SM, MAX_SMEM = _build.H100
WIDTHS = list(range(128, 4097, 128))


# -- the LSTM family's plans at every width the JAX gate admits ---------------


@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("kernel", ["fwd_stacked", "fwd_layer0", "fwd_bilstm", "bwd_ge2e",
                                    "bwd_bilstm"])
def test_lstm_family_plans_a_row_at_every_jax_width(kernel, H):
    """#2 / #2r (a stacked layer, D = H, and GE2E's layer 0, D 80), #3 / #3r
    (D 0, two directions), #8 and #9 take at least one row a launch at every
    H % 128 from 128 to 4096 on an H100, and their layout fits it."""
    if kernel.startswith("fwd"):
        ndir, D = {"fwd_stacked": (1, H), "fwd_layer0": (1, 80), "fwd_bilstm": (2, 0)}[kernel]
        for B in (1, 8, 32, 640):
            rows = lstm_kernel.fwd_rows(ndir, D, H, B)
            assert 1 <= rows <= min(B, 32)
            lay = lstm_kernel.fwd_layout(ndir, D, H, B, rows)
            assert lay["fits"] and lay["bytes"] <= MAX_SMEM
            assert len(lstm_kernel.fwd_row_groups(ndir, D, H, B)) == -(-B // rows)
    else:
        ndir = 1 if kernel == "bwd_ge2e" else 2
        for B in (1, 8, 32, 640):
            rows = lstm_kernel.bwd_rows(ndir, H, B)
            assert 1 <= rows <= B
            lay = lstm_kernel.bwd_layout(ndir, H, B, rows)
            assert lay["fits"] and lay["bytes"] <= MAX_SMEM
            if rows < B:
                assert not lstm_kernel.bwd_layout(ndir, H, B, rows + 1)["fits"]


def test_lstm_family_plans_a_row_at_every_h_multiple_of_8():
    """Every H % 8 up to 4096 takes one row a launch on an H100, forward
    (D = H, D 80, the BiLSTM) and backward (one and two directions)."""
    for H in range(8, 4097, 8):
        assert all(lstm_kernel.fwd_rows(ndir, D, H, 1) == 1
                   for ndir, D in ((1, H), (1, 80), (2, 0))), H
        assert lstm_kernel.bwd_rows(1, H, 1) == lstm_kernel.bwd_rows(2, H, 1) == 1, H


@pytest.mark.parametrize("ndir, D, H", [(1, 768, 768), (1, 80, 768), (2, 0, 256)])
def test_lstm_forward_keeps_the_production_layout(ndir, D, H):
    """GE2E's 768 (both layer kinds) and the text encoder's BiLSTM (256 a
    direction) keep the full layout (W_ih and W_hh resident, 8 partial
    slots) and 32 rows a launch: the bytes of ``lstm_smem_bytes``."""
    for B in (3, 32, 640):
        rows = lstm_kernel.fwd_rows(ndir, D, H, B)
        assert rows == min(B, 32)
        lay = lstm_kernel.fwd_layout(ndir, D, H, B, rows)
        U, _ = _build.recurrence_grid(ndir, H, N_SM)
        assert not lay["wide"] and lay["bytes"] == lstm_kernel.fwd_smem_bytes(U, D, H, rows)
        assert lay["ntr"] == _build.round_up(4 * U, 8) // 8


@pytest.mark.parametrize("ndir, H, B, rows", [(1, 768, 640, 352), (1, 768, 32, 32),
                                              (1, 1024, 640, 288), (2, 256, 640, 512)])
def test_lstm_backward_keeps_the_production_layout(ndir, H, B, rows):
    assert lstm_kernel.bwd_rows(ndir, H, B) == rows
    assert not lstm_kernel.bwd_layout(ndir, H, B, rows)["wide"]


@pytest.mark.parametrize("ndir, D, H, B, ntr, nt", [
    (1, 1792, 1792, 32, 2, 7),   # GE2E LSTM.Sizes 1792: W_hh tiles streamed
    (1, 80, 1792, 32, 2, 7),
    (1, 1152, 1152, 32, 5, 5),   # W_ih from L2, W_hh resident
    (2, 0, 1152, 32, 5, 9),      # Encoder.LSTM_Size 2304
    (2, 0, 1152, 8, 9, 9),
    (2, 0, 4096, 32, 0, 32),     # every W_hh tile streamed, 16 rows a launch
])
def test_lstm_forward_wide_layout(ndir, D, H, B, ntr, nt):
    rows = lstm_kernel.fwd_rows(ndir, D, H, B)
    lay = lstm_kernel.fwd_layout(ndir, D, H, B, rows)
    assert lay["wide"] and lay["ntr"] == ntr
    assert _build.round_up(4 * lay["U"], 8) // 8 == nt
    assert rows == (16 if H == 4096 else min(B, 32))


@pytest.mark.parametrize("ndir, H, B, rows, ntr", [
    (1, 1792, 160, 160, 0), (1, 1792, 640, 210, 0), (1, 1792, 8, 8, 1),
    (2, 1152, 8, 8, 2), (2, 1152, 32, 32, 2), (2, 1064, 8, 8, 2),
])
def test_lstm_backward_wide_layout(ndir, H, B, rows, ntr):
    assert lstm_kernel.bwd_rows(ndir, H, B) == rows
    lay = lstm_kernel.bwd_layout(ndir, H, B, rows)
    assert lay["wide"] and lay["ntr"] == ntr


def _fake_libs(monkeypatch, kernels, calls):
    """Replace the kernels' libraries: every entry point records its call
    (kernel, entry point, arguments) and returns success, so a wrapper runs
    on the CPU to its launch."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    for kern in kernels:
        monkeypatch.setattr(kern, "lib", lambda kern=kern: type("Lib", (), {
            fn: staticmethod(lambda *a, fn=fn: calls.append((kern.name, fn, a)) or 0)
            for fn in kern.functions})())


@pytest.mark.parametrize("B, H, launches", [(640, 768, 20), (32, 768, 1), (33, 768, 2),
                                            (32, 1792, 1), (40, 1792, 2)])
@pytest.mark.parametrize("residuals", [False, True])
def test_lstm_forward_counts_a_launch_a_group(monkeypatch, B, H, launches, residuals):
    """One entry call and one count a row group of the forward, in its own
    counter: 20 at GE2E's 640 rows."""
    calls = []
    kern = lstm_kernel.RES_KERNEL if residuals else lstm_kernel.KERNEL
    _fake_libs(monkeypatch, [lstm_kernel.KERNEL, lstm_kernel.RES_KERNEL], calls)
    T, D = 3, H
    p = LSTMParams(torch.zeros(D, 4 * H), torch.zeros(H, 4 * H), torch.zeros(4 * H))
    before = (lstm_kernel.KERNEL.launches, lstm_kernel.RES_KERNEL.launches)
    lstm_kernel.lstm_seq_layer_kernel(p, torch.zeros(T, B, D, dtype=torch.bfloat16), residuals)
    assert [c[:2] for c in calls] == [(kern.name, "mstts_lstm_layer_fwd")] * launches
    moved = (lstm_kernel.KERNEL.launches - before[0], lstm_kernel.RES_KERNEL.launches - before[1])
    assert moved == ((0, launches) if residuals else (launches, 0))
    groups = lstm_kernel.fwd_row_groups(1, D, H, B)
    assert [c[2][-3:-1] for c in calls] == [(g.start, g.stop - g.start) for g in groups]
    assert [c[2][-7:-3] for c in calls] == [(T, B, D, H)] * launches
    assert len({c[2][9] for c in calls}) == launches  # a barrier counter each


@pytest.mark.parametrize("B, H, launches", [(100, 256, 4), (8, 1152, 1), (32, 4096, 2)])
def test_bilstm_forward_counts_a_launch_a_group(monkeypatch, B, H, launches):
    calls = []
    _fake_libs(monkeypatch, [birnn_kernel.KERNEL], calls)
    T = 3
    g = torch.zeros(T, B, 4 * H, dtype=torch.bfloat16)
    w = torch.zeros(H, 4 * H)
    before = birnn_kernel.KERNEL.launches
    birnn_kernel.bilstm_recurrence_kernel(g, g, w, w)
    assert [c[:2] for c in calls] == [("bilstm", "mstts_bilstm_fwd")] * launches
    assert birnn_kernel.KERNEL.launches == before + launches
    groups = lstm_kernel.fwd_row_groups(2, 0, H, B)
    assert [c[2][-3:-1] for c in calls] == [(g.start, g.stop - g.start) for g in groups]
    assert [c[2][-6:-3] for c in calls] == [(T, B, H)] * launches


# -- the Griffin-Lim route ----------------------------------------------------


def _jax_gl_decision(T, n_fft, hop, B, momentum, dense_env):
    """``griffin_lim_auto``'s choice on a TPU for an eligible (B, T, F)
    magnitude, from the JAX package's own ``_pallas_gl_max_batch``."""
    max_b, kind = _pallas_gl_max_batch(T, n_fft, hop, momentum), "dense"
    if n_fft == 1024 and not dense_env:
        staged = _pallas_gl_max_batch(T, n_fft, hop, momentum, staged=True)
        if staged > max_b:
            max_b, kind = staged, "staged"
    return kind if max_b >= min(B, 8) else "gemm"


GL_T = [1, 47, 128, 304, 305, 400, 1000, 1024, 1200, 1266, 1267, 1268, 1300, 2000]
GL_SIZES = [(1024, 256), (512, 128), (2048, 256), (2048, 512), (4096, 512), (8192, 1024),
            (16384, 2048)]


@pytest.mark.parametrize("dense_env", [False, True])
@pytest.mark.parametrize("momentum", [0.0, 0.99])
@pytest.mark.parametrize("n_fft, hop", GL_SIZES)
def test_gl_route_is_the_jax_decision(monkeypatch, n_fft, hop, momentum, dense_env):
    if dense_env:
        monkeypatch.setenv("GL_DENSE_KERNEL", "1")
    else:
        monkeypatch.delenv("GL_DENSE_KERNEL", raising=False)
    routes = set()
    for T in GL_T:
        for B in (1, 2, 3, 8, 9, 64):
            want = _jax_gl_decision(T, n_fft, hop, B, momentum, dense_env)
            got = stft_matmul.gl_route(3, n_fft, hop, T, hop * (T - 1), True, B, momentum)
            assert got == want, (T, B)
            routes.add(got)
            # Off the card, or at another length, the GEMM route as before.
            assert stft_matmul.gl_route(3, n_fft, hop, T, hop * (T - 1), False, B,
                                        momentum) == "gemm"
    assert "gemm" in routes and len(routes) >= 2


def test_gl_route_at_long_t():
    """At n_fft 1024 the staged kernel's own cap decides, as in the JAX
    package: T 1300 goes to GEMM at any batch, T 1200 under momentum 0.99
    too; the dense kernel's cap at 4096 / 512 likewise from T 304 / 305."""
    assert stft_matmul.gl_route(3, 1024, 256, 1300, 256 * 1299, True, 1, 0.0) == "gemm"
    assert stft_matmul.gl_route(3, 1024, 256, 1024, 256 * 1023, True, 8, 0.0) == "staged"
    assert stft_matmul.gl_route(3, 1024, 256, 1200, 256 * 1199, True, 1, 0.99) == "gemm"
    assert stft_matmul.gl_route(3, 1024, 256, 1200, 256 * 1199, True, 1, 0.0) == "staged"
    assert stft_matmul.gl_route(3, 4096, 512, 400, 512 * 399, True, 1, 0.0) == "gemm"
    assert stft_matmul.gl_route(3, 4096, 512, 304, 512 * 303, True, 2, 0.0) == "dense"
    assert stft_matmul.gl_route(3, 4096, 512, 304, 512 * 303, True, 3, 0.0) == "gemm"
    for T in range(1, 3000, 37):
        for n_fft, hop in GL_SIZES:
            for staged in (False, True):
                assert stft_matmul.reference_gl_max_batch(T, n_fft, hop, 0.5, staged) == \
                    _pallas_gl_max_batch(T, n_fft, hop, 0.5, staged)


def test_griffin_lim_auto_on_a_pretended_card_takes_gemm_at_long_t(monkeypatch, capsys):
    """The vocoder at T 1300 (n_fft 1024) prints its GEMM line and launches
    no Griffin-Lim kernel; its wav is ``griffin_lim_matmul``'s."""
    from multi_speaker_tts_tpu_torch.ops import griffin_lim_kernel, griffin_lim_staged

    mag = torch.from_numpy(np.random.default_rng(0).random((1, 1300, 513)).astype(np.float32))
    want = stft_matmul.griffin_lim_matmul(mag, 1024, 256, 1, 256 * 1299)
    calls = []
    _fake_libs(monkeypatch, [griffin_lim_staged.KERNEL, griffin_lim_staged.MOM_KERNEL,
                             griffin_lim_kernel.KERNEL], calls)
    monkeypatch.delenv("GL_DENSE_KERNEL", raising=False)
    monkeypatch.setattr(dsp, "_DISPATCH_LOGGED", set())
    got = stft_matmul.griffin_lim_auto(mag, 1024, 256, 1, 256 * 1299)
    assert calls == [] and torch.equal(got, want)
    assert "[dispatch] griffin_lim -> gemm" in capsys.readouterr().out


# -- the decode route ----------------------------------------------------------


def _params(H, D, P=256, A=128):
    z = lambda *s: torch.zeros(()).expand(*s)  # noqa: E731
    lstm = (LSTMParams(z(P + D, 4 * H), z(H, 4 * H), z(4 * H)),
            LSTMParams(z(H + D, 4 * H), z(H, 4 * H), z(4 * H)))
    return dscan.DecoderParams(lstm, dscan.AttentionParams(z(H, A), z(31, 2, 32), z(32, A),
                                                           z(A, 1)),
                               (z(H + D, 160), z(160)), (z(H + D, 1), z(1)))


def _jax_params(H, D, P=256, A=128):
    z = lambda *s: np.broadcast_to(np.float32(0), s)  # noqa: E731
    return jdscan.DecoderScanParams(
        lstm=(JaxLSTMParams(z(P + D, 4 * H), z(H, 4 * H), z(4 * H)),
              JaxLSTMParams(z(H + D, 4 * H), z(H, 4 * H), z(4 * H))),
        attention=jdscan.AttentionParams(z(H, A), z(31, 2, 32), z(32, A), z(A, 1)))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("H", [1024, 1536, 2048, 2064, 2176, 2304, 2560])
@pytest.mark.parametrize("D", [512, 768])
def test_decode_route_is_the_jax_decision(mode, H, D):
    """On the card the decode runs the plain loop exactly where the port's
    kernel and ``decode_pallas.supported`` both refuse (bf16 past the 80 MB
    rule and H 2048); int8 past H 2048 the kernel takes what the JAX gate
    takes; off the card nothing changes but the positions rule."""
    q = mode == "int8"
    p, jp = _params(H, D), _jax_params(H, D)
    for S in (64, 208, 256, 272, 1008):
        port_ok = dk.supported(p, (256, 256), D, S, 80, q)
        jax_ok = jdk.supported(jp, 256, D, S, mode=mode)
        assert dk.reference_supported(p, (256, 256), D, S, q) == jax_ok
        reason = dk.plain_reason(p, (256, 256), D, S, 80, q, dk.H100, True)
        assert (reason is not None) == (not port_ok and not jax_ok), S
        if reason is not None and H > 2048:
            assert "gate rows a block" in reason and "refuses it too" in reason
        off = dk.plain_reason(p, (256, 256), D, S, 80, q, dk.H100, False)
        assert off is None or "memory positions" in off
    if mode == "bf16" and H >= 2176:
        assert dk.plain_reason(p, (256, 256), D, 64, 80, q, dk.H100, True) is not None
    if mode == "int8" and H >= 2176:  # the JAX gate launches, and so does the port
        assert dk.plain_reason(p, (256, 256), D, 64, 80, q, dk.H100, True) is None
        assert dk.supported(p, (256, 256), D, 64, 80, q)


@pytest.mark.parametrize("H_lo, H_hi", [(128, 2048), (2048, 4096), (4096, 6144), (6144, 8193)])
def test_decode_int8_launches_wherever_jax_does(H_lo, H_hi):
    """Over H 128-8192 (multiples of 128), memory 256-768, attention 128-1024
    and S 1-256: wherever ``decode_pallas.supported(..., mode="int8")`` is
    true the port's kernel takes the shape (``_shape_reason`` None), so
    the decode runs the kernel on the card and no plain loop."""
    launched = 0
    for H in range(H_lo, H_hi, 128):
        for D in (256, 512, 768):
            for A in (128, 640, 1024):
                jp = _jax_params(H, D, A=A)
                p = _params(H, D, A=A)
                for S in (1, 64, 208, 256):
                    if not jdk.supported(jp, 256, D, S, mode="int8"):
                        continue
                    launched += 1
                    assert dk._shape_reason(H, D, (256, 256), S, A, 80, 32, 31, True) is None, \
                        (H, D, A, S)
                    assert dk.plain_reason(p, (256, 256), D, S, 80, True, dk.H100, True) is None
    assert launched == 3 * 3 * 4 * len(range(H_lo, H_hi, 128))


@pytest.mark.parametrize("H", range(128, 4097, 128))
def test_bigru_launches_wherever_jax_does(H):
    """Every width ``birnn_pallas.supported`` takes up to 4096 (bf16, H %
    128) the port takes on its wide route (past 1,248 a direction, with
    streamed tiles where the slice does not hold 32 rows), forward and
    backward, with no plain route."""
    assert birnn_pallas.supported(H, jnp.bfloat16)
    shapes = ((7, 8, 3 * H), ((H, 3 * H), (H, 3 * H)))
    assert birnn_kernel.bigru_shape_reason(*shapes) is None
    assert birnn_kernel.bigru_bwd_shape_reason(*shapes) is None
    assert not _build.plain_route("bigru", torch.zeros(1), torch.bfloat16,
                                  lambda: birnn_kernel.bigru_shape_reason(*shapes),
                                  _build.reference_widths_ok(H))
    if H > 192:
        assert all(birnn_kernel.wide_rows(bwd, H, 8) >= 1 for bwd in (False, True))


@pytest.mark.parametrize("n_lo, n_hi", [(256, 8192), (8192, 24576), (24576, 65537)])
def test_gl_dense_launches_wherever_jax_does(n_lo, n_hi):
    """Every 256-multiple n_fft up to 65536, every hop the JAX dispatch
    admits, T up to and past its cap, B 1 and 8: wherever
    ``_pallas_gl_max_batch(T, n_fft, hop) >= min(B, 8)`` the port routes to
    the dense kernel (n_fft 1024 aside, where the staged one may win) and
    the kernel has a tiling; elsewhere the GEMM route."""
    dense = 0
    for n_fft in range(n_lo, n_hi, 256):
        for k in range(2, n_fft // 128 + 1, 2):
            hop = n_fft // k
            if n_fft % k or hop % 128:
                continue
            for T in (2, 20, 40, 79, 157, 304, 305, 600):
                for B in (1, 8):
                    admitted = _pallas_gl_max_batch(T, n_fft, hop) >= min(B, 8)
                    got = stft_matmul.gl_route(3, n_fft, hop, T, hop * (T - 1), True, B, 0.0)
                    if n_fft == 1024:
                        assert (got != "gemm") == admitted
                        continue
                    assert got == ("dense" if admitted else "gemm"), (n_fft, hop, T, B)
                    if admitted and B == 1:
                        gk.dense_plan(B, T, n_fft, hop)  # raises if no tiling fits
                        dense += 1
    assert dense > 0


# -- the recurrence routes -----------------------------------------------------


@pytest.mark.parametrize("H", [128, 256, 768, 1152, 1160, 1164, 1248, 1264, 1280, 1792, 4096])
def test_recurrence_routes_are_the_jax_decision(H):
    """The width half of the JAX gates is the port's copy, and the port's
    refusals: every H % 8 for the LSTM family, H % 16 up to 4,880 for the
    BiGRU."""
    jl = [JaxLSTMParams(np.zeros((80, 4 * H)), np.zeros((H, 4 * H)), np.zeros(4 * H))]
    assert _build.reference_widths_ok(H) == lstm_pallas.supported(jl, jnp.bfloat16)
    assert _build.reference_widths_ok(H) == birnn_pallas.supported(H, jnp.bfloat16)
    p = LSTMParams(torch.zeros(80, 4 * H), torch.zeros(H, 4 * H), torch.zeros(4 * H))
    for grad in (False, True):
        assert (lstm_kernel.stack_refusal([p], 32, grad) is None) == (H % 8 == 0)
        assert (birnn_kernel.bilstm_refusal(H, 32, grad) is None) == (H % 8 == 0)
    gru_refuses = birnn_kernel.bigru_shape_reason((4, 2, 3 * H), [(H, 3 * H)] * 2) is not None
    assert gru_refuses == (H % 16 != 0 or H > 4880)


def _gru(H, D, rng):
    return gru.GRUParams(*(torch.from_numpy((rng.standard_normal(s) * 0.05).astype(np.float32))
                           for s in ((D, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))))


def _lstm(H, D, rng):
    return LSTMParams(*(torch.from_numpy((rng.standard_normal(s) * 0.05).astype(np.float32))
                        for s in ((D, 4 * H), (H, 4 * H), (4 * H,))))


def _recurrence_kernels():
    return [lstm_kernel.KERNEL, lstm_kernel.RES_KERNEL, lstm_kernel.BWD_KERNEL,
            birnn_kernel.KERNEL, birnn_kernel.RES_KERNEL, birnn_kernel.BWD_KERNEL,
            birnn_kernel.GRU_KERNEL, birnn_kernel.GRU_RES_KERNEL, birnn_kernel.GRU_BWD_KERNEL,
            birnn_kernel.WIDE_GRU_KERNEL, birnn_kernel.WIDE_GRU_RES_KERNEL,
            birnn_kernel.WIDE_GRU_BWD_KERNEL]


def test_bigru_past_the_kernels_where_jax_refuses_runs_plain(monkeypatch, capsys):
    """On a pretended card the BiGRU at H 1260 (not a multiple of 16, nor
    of 128) runs ``bigru_fused`` with one dispatch line and no launch; at
    H 1280 (the JAX gate launches) the wrapper launches the wide route, in
    its streamed build."""
    rng = np.random.default_rng(1264)
    fwd, bwd = _gru(1260, 16, rng), _gru(1260, 16, rng)
    x = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(np.float32))
    want = gru.bigru_fused(fwd, bwd, x, torch.bfloat16)
    calls = []
    _fake_libs(monkeypatch, _recurrence_kernels(), calls)
    monkeypatch.setattr(dsp, "_DISPATCH_LOGGED", set())
    got = birnn_kernel.bigru(fwd, bwd, x, torch.bfloat16)
    assert calls == [] and torch.equal(got, want)
    out = capsys.readouterr().out
    assert "[dispatch] bigru -> plain" in out and "4880" in out
    f2, b2 = _gru(1280, 16, rng), _gru(1280, 16, rng)
    birnn_kernel.bigru(f2, b2, x, torch.bfloat16)
    assert [c[:2] for c in calls] == [("bigru_wide", "mstts_bigru_wide_fwd")]
    assert birnn_kernel.wide_layout(False, 1280, 3)["stream"]
    assert "[dispatch]" not in capsys.readouterr().out


@pytest.mark.parametrize("grad", [False, True])
def test_lstm_stacks_at_a_width_neither_takes_run_plain(monkeypatch, capsys, grad):
    """H 12 (not a multiple of 8, nor of 128): the GE2E stack and the BiLSTM
    run their plain versions on a pretended card, under autograd too, with
    a dispatch line each and no launch."""
    rng = np.random.default_rng(12)
    layers = [_lstm(12, 16, rng), _lstm(12, 12, rng)]
    fwd, bwd = _lstm(12, 16, rng), _lstm(12, 16, rng)
    x = torch.from_numpy(rng.standard_normal((2, 5, 16)).astype(np.float32))
    want_stack = lstm_stack(layers, x, torch.bfloat16)
    want_bi = bilstm_fused(fwd, bwd, x, torch.bfloat16)
    calls = []
    _fake_libs(monkeypatch, _recurrence_kernels(), calls)
    monkeypatch.setattr(dsp, "_DISPATCH_LOGGED", set())
    if grad:
        x = x.clone().requires_grad_(True)
    ys, h = lstm_kernel.lstm_stack_seq(layers, x, torch.bfloat16)
    bi = birnn_kernel.bilstm(fwd, bwd, x, torch.bfloat16)
    if grad:
        (ys.sum() + bi.sum()).backward()
        assert torch.isfinite(x.grad).all()
    assert calls == []
    assert torch.equal(ys.detach(), want_stack[0]) and torch.equal(h.detach(), want_stack[1])
    assert torch.equal(bi.detach(), want_bi)
    out = capsys.readouterr().out
    assert "[dispatch] ge2e_lstm -> plain" in out and "[dispatch] bilstm -> plain" in out


# -- the CLIs ------------------------------------------------------------------


class _Stop(Exception):
    pass


@pytest.mark.parametrize("cli", [serve, inference])
def test_hp_flag_reaches_the_synthesizer(monkeypatch, tmp_path, cli):
    """``-hp FILE.json`` replaces the checkpoint's hyper-parameters in the
    daemon and in the inference CLI, as the JAX CLIs' ``-hp`` does."""
    from multi_speaker_tts_tpu.train.checkpoints import load_compact

    ckpt = ROOT / "demo" / "serving_ckpt.msgpack"
    hp = load_compact(ckpt)[2]["hp"]
    hp["Sound"]["Griffin_Lim_Iter"] = 7
    hp_file = tmp_path / "hp.json"
    hp_file.write_text(json.dumps(hp))
    seen = []
    real = inference.Synthesizer.from_path.__func__

    def from_path(cls, path, **kw):
        seen.append(real(cls, path, **kw))
        raise _Stop

    monkeypatch.setattr(inference.Synthesizer, "from_path", classmethod(from_path))
    argv = ["-checkpoint", str(ckpt), "-device", "cpu", "-text", "a"] if cli is inference \
        else ["-checkpoint", str(ckpt), "-device", "cpu"]
    with pytest.raises(_Stop):
        cli.main(argv + ["-hp", str(hp_file)])
    assert seen[-1].hp.Sound.Griffin_Lim_Iter == 7 and seen[-1].hp.to_dict() == hp
    with pytest.raises(_Stop):
        cli.main(argv)
    assert seen[-1].hp.Sound.Griffin_Lim_Iter != 7


def test_debug_nans_names_the_module_forward_and_backward():
    class Sqrt(torch.nn.Module):
        def forward(self, z):
            return torch.sqrt(z)  # at 0: finite forward, infinite input gradient

    class Root(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(3, 3)
            self.act = Sqrt()

        def forward(self, x):
            return self.act(self.lin(x) * 0.0)

    m = Root()
    handles = debug_nans.install({"root": m})
    x = torch.ones(2, 3, requires_grad=True)
    y = m(x)
    with pytest.raises(FloatingPointError, match="backward output .* module 'root.act'"):
        y.sum().backward()
    with torch.no_grad():
        m.lin.weight[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="forward output of module 'root.lin'"):
        m(x)
    for h in handles:
        h.remove()
    assert torch.isnan(m(x)).any()  # removed: no check


def test_train_cli_debug_nans_raises_on_a_planted_nan(monkeypatch, tmp_path):
    """``-debug_nans`` on the GE2E trainer with one NaN weight planted: the
    first step raises, naming the module; without the flag the step runs
    (and the trainer's non-finite guard skips it)."""
    hp = tiny_test_hparams().replace(
        GE2E_Train={"Batch_Speakers": 3, "Batch_Utterances": 2, "Frame_Length": 24})
    generate_synthetic_dataset(hp, tmp_path / "corpus", n_speakers=3, n_utterances=2)
    hp_file = tmp_path / "hp.json"
    hp_file.write_text(json.dumps(hp.to_dict()))
    init = GE2ETrainer.__init__

    def planted(self, *a, **kw):
        init(self, *a, **kw)
        with torch.no_grad():
            self.model.projection.kernel.view(-1)[0] = float("nan")

    monkeypatch.setattr(GE2ETrainer, "__init__", planted)
    argv = ["-hp", str(hp_file), "-mode", "ge2e", "-train_pattern",
            str(tmp_path / "corpus" / "patterns"), "-log", str(tmp_path / "log"), "-device",
            "cpu", "-max_step", "1"]
    with pytest.raises(FloatingPointError, match="module 'encoder.projection'"):
        train_cli.main(argv + ["-checkpoint", str(tmp_path / "a"), "-debug_nans"])
    train_cli.main(argv + ["-checkpoint", str(tmp_path / "b")])
    assert os.path.isdir(tmp_path / "b")
