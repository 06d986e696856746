"""The kernels at every batch and width the reference's gates admit, on the
CPU: the launch plans the wrappers compute for an H100 (the LSTM backward's
row groups, the BiGRU's route and the wide route's rows, the decode
kernel's layout past H 1024, the mel front-end's route and mode at any
n_fft), the wrappers' choice of entry point and launch counts on a
pretended card, and the plain versions that the card's kernels are held to
at those widths against the JAX package: the BiGRU at H 256 against
``bigru_fused`` (f32) and ``bigru_pallas(..., interpret=True)`` (bf16), the
mel front-end at n_fft 32, 128 and 8192 against ``dsp.melspectrogram``,
and at 128 against ``melspectrogram_pallas`` in interpret mode. The kernels
themselves run only on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.audio import dsp as jdsp
from multi_speaker_tts_tpu.ops import birnn_pallas
from multi_speaker_tts_tpu.ops import gru as jgru
from multi_speaker_tts_tpu.ops import mel_kernel as jmel
from multi_speaker_tts_tpu_torch.audio import dsp
from multi_speaker_tts_tpu_torch.ops import _build, birnn_kernel, gru, lstm_kernel, mel_kernel
from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

N_SM, MAX_SMEM = _build.H100


# -- the LSTM backward (#8, #9) in row groups ----------------------------------


@pytest.mark.parametrize("ndir, H, B, rows", [
    (1, 768, 640, 352),   # GE2E's published 64 x 10 batch at the repo's GE2E width
    (1, 768, 32, 32),     # the train phase's batch: one launch, as before
    (1, 1024, 640, 288),
    (2, 256, 640, 512),   # the text encoder's BiLSTM
    (2, 256, 32, 32),
])
def test_lstm_bwd_row_plan_at_h100(ndir, H, B, rows):
    """The reverse kernel's launches take as many rows as a block's shared
    memory holds (``lstm_bwd_smem_bytes`` in Python): each group within the
    H100's opt-in bytes, one row more past them, every row covered once."""
    assert lstm_kernel.bwd_rows(ndir, H, B) == rows
    U, _ = _build.recurrence_grid(ndir, H, N_SM)
    groups = lstm_kernel.bwd_row_groups(ndir, H, B)
    assert [i for g in groups for i in range(B)[g]] == list(range(B))
    assert len(groups) == -(-B // rows) and (B <= rows or len(groups) >= 2)
    assert all(lstm_kernel.bwd_smem_bytes(U, H, g.stop - g.start) <= MAX_SMEM for g in groups)
    if rows < B:
        assert lstm_kernel.bwd_smem_bytes(U, H, rows + 1) > MAX_SMEM


def test_lstm_bwd_refuses_past_its_n_tiles():
    """Where one row no longer fits beside the resident W_hh rows (a GE2E
    layer from H 1680 on an H100), or a block owns more than 16 units (the
    BiLSTM from H 1064 a direction), the launch takes the wide layout and
    build (W_hh tiles read from L2, up to 64 units a block); past 64 units
    a block (H 8456 for one direction, 4232 a direction for two) the
    kernel still has no launch: the plan says so and the wrapper raises."""
    assert lstm_kernel.bwd_rows(1, 1664, 8) >= 1
    assert lstm_kernel.bwd_rows(1, 1680, 8) == 8
    assert lstm_kernel.bwd_rows(2, 1056, 8) >= 1
    assert lstm_kernel.bwd_rows(2, 1072, 8) == 8
    assert not lstm_kernel.bwd_layout(2, 1056, 8, 8)["wide"]
    for ndir, H in ((1, 1680), (2, 1064), (2, 1072)):
        assert lstm_kernel.bwd_layout(ndir, H, 8, 8)["wide"]
    assert lstm_kernel.bwd_rows(1, 8448, 8) == 8 and lstm_kernel.bwd_rows(2, 4224, 8) == 8
    for ndir, H in ((1, 8456), (2, 4232)):
        assert lstm_kernel.bwd_rows(ndir, H, 8) == 0
        with pytest.raises(ValueError, match="64 units a block"):
            lstm_kernel.bwd_row_groups(ndir, H, 8)


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


@pytest.mark.parametrize("B, launches", [(32, 1), (352, 1), (353, 2), (640, 2)])
def test_lstm_bwd_wrapper_counts_a_launch_a_group(monkeypatch, B, launches):
    calls = []
    _fake_libs(monkeypatch, [lstm_kernel.BWD_KERNEL], calls)
    T, H = 3, 768
    gates = torch.zeros(T, B, 4 * H, dtype=torch.bfloat16)
    c_prev = torch.zeros(T, B, H, dtype=torch.bfloat16)
    before = lstm_kernel.BWD_KERNEL.launches
    lstm_kernel.lstm_seq_layer_bwd_kernel(torch.zeros(H, 4 * H), gates, c_prev, None, None)
    assert [c[:2] for c in calls] == [("ge2e_lstm_bwd", "mstts_lstm_layer_bwd")] * launches
    assert lstm_kernel.BWD_KERNEL.launches == before + launches
    # One entry call a group: its first row and rows, a barrier counter each.
    groups = lstm_kernel.bwd_row_groups(1, H, B)
    assert [c[2][-3:-1] for c in calls] == [(g.start, g.stop - g.start) for g in groups]
    assert [c[2][-6:-3] for c in calls] == [(T, B, H)] * launches
    assert len({c[2][6] for c in calls}) == launches


# -- the BiGRU (#5, #5r, #10) past H 192 ---------------------------------------


@pytest.mark.parametrize("H", [16, 128, 192, 208, 256, 384, 512, 1024, 1248])
def test_bigru_route_by_width(H):
    """Up to H 192 the narrow kernels (W_hh in one block), above the wide
    route; both take every H % 16 up to 1,248 on an H100, the wide route's
    forward and backward 32 rows a launch up to H 1024 (fewer above)."""
    shapes = ((9, 32, 3 * H), ((H, 3 * H), (H, 3 * H)))
    assert birnn_kernel.bigru_shape_reason(*shapes) is None
    assert birnn_kernel.bigru_bwd_shape_reason(*shapes) is None
    assert birnn_kernel.bigru_route(H) == ("narrow" if H <= 192 else "wide")
    if H > 192:
        U, _ = _build.recurrence_grid(2, H, N_SM)
        for bwd in (False, True):
            rows = birnn_kernel.wide_rows(bwd, H, 32)
            assert rows == 32 or (H > 1024 and rows >= 1)
            assert birnn_kernel.wide_smem_bytes(bwd, U, H, rows) <= MAX_SMEM


def test_bigru_wide_route_limit_and_row_groups():
    assert birnn_kernel.wide_max_h() == 1248
    assert all(birnn_kernel.bigru_shape_reason((4, 2, 3 * H), [(H, 3 * H)] * 2) is None
               for H in range(208, 1249, 16))
    reason = birnn_kernel.bigru_shape_reason((4, 2, 3 * 1264), [(1264, 3 * 1264)] * 2)
    assert "16 <= H <= 1248" in reason
    # Rows past what one launch holds run in groups.
    rows = birnn_kernel.wide_rows(True, 1024, 400)
    assert 32 < rows < 400
    groups = birnn_kernel.wide_row_groups(True, 1024, 400, _build.H100)
    assert len(groups) == -(-400 // rows) and groups[-1].stop == 400


@pytest.mark.parametrize("H, route", [(128, "narrow"), (256, "wide"), (1024, "wide")])
def test_bigru_wrappers_pick_their_route(monkeypatch, H, route):
    """On a pretended card the forward, its residual mode and the backward
    call the route's entry points, each counting its launches."""
    calls = []
    kernels = [birnn_kernel.GRU_KERNEL, birnn_kernel.GRU_RES_KERNEL, birnn_kernel.GRU_BWD_KERNEL,
               birnn_kernel.WIDE_GRU_KERNEL, birnn_kernel.WIDE_GRU_RES_KERNEL,
               birnn_kernel.WIDE_GRU_BWD_KERNEL]
    _fake_libs(monkeypatch, kernels, calls)
    T, B = 3, 2
    p = gru.GRUParams(torch.zeros(8, 3 * H), torch.zeros(H, 3 * H), torch.zeros(3 * H),
                      torch.zeros(3 * H))
    g = torch.zeros(T, B, 3 * H, dtype=torch.bfloat16)
    hp = torch.zeros(T, B, H, dtype=torch.bfloat16)
    dy = torch.zeros(T, B, H)
    before = [k.launches for k in kernels]
    birnn_kernel.bigru_recurrence_kernel(g, g, p, p)
    birnn_kernel.bigru_recurrence_kernel(g, g, p, p, save_residuals=True)
    birnn_kernel.bigru_bwd_kernel(g, g, hp, g, g, hp, p.w_hh, p.w_hh, dy, dy)
    prefix = "bigru" if route == "narrow" else "bigru_wide"
    entry = "mstts_bigru" if route == "narrow" else "mstts_bigru_wide"
    assert [c[:2] for c in calls] == [(prefix, f"{entry}_fwd"),
                                      (f"{prefix}_residuals", f"{entry}_fwd"),
                                      (f"{prefix}_bwd", f"{entry}_bwd")]
    moved = [k.launches - b for k, b in zip(kernels, before)]
    assert moved == ([1, 1, 1, 0, 0, 0] if route == "narrow" else [0, 0, 0, 1, 1, 1])


def _gru_params(rng, D, H, scale):
    shapes = ((D, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))
    arrays = [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
    return (jgru.GRUParams(*map(jnp.asarray, arrays)),
            gru.GRUParams(*map(torch.from_numpy, arrays)))


@pytest.fixture(scope="module")
def jax_bigru():
    """The JAX package's BiGRU at H 256, run once for the module: its f32
    reference (``bigru_fused``) and the Pallas kernel in interpret mode
    (bf16), with the inputs and the port's copy of the weights."""
    rng = np.random.default_rng(256)
    H, B, T, D = 256, 2, 12, 64
    (jf, tf), (jb, tb) = _gru_params(rng, D, H, 0.06), _gru_params(rng, D, H, 0.06)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    fused = np.asarray(jgru.bigru_fused(jf, jb, jnp.asarray(x)))
    pallas = np.asarray(birnn_pallas.bigru_pallas(jf, jb, jnp.asarray(x), jnp.bfloat16,
                                                  interpret=True))
    return {"x": x, "tf": tf, "tb": tb, "fused": fused, "pallas": pallas}


def test_plain_bigru_at_h256_matches_bigru_fused(jax_bigru):
    """f32 on both sides: the port's f32 reference and its hoisted-gate
    recurrence (the wide kernel's plain version in f32) within 1e-5."""
    x = torch.from_numpy(jax_bigru["x"])
    got = gru.bigru_fused(jax_bigru["tf"], jax_bigru["tb"], x).numpy()
    assert got.shape == jax_bigru["fused"].shape == (2, 12, 512)
    assert np.abs(got - jax_bigru["fused"]).max() <= 1e-5
    via_hoist = birnn_kernel.bigru(jax_bigru["tf"], jax_bigru["tb"], x, torch.float32).numpy()
    assert np.abs(via_hoist - jax_bigru["fused"]).max() <= 1e-5


def test_plain_bigru_at_h256_matches_the_pallas_kernel_in_interpret_mode(jax_bigru):
    """bf16 hoisted gates, bf16 operand h, f32 carry, bf16 outputs on both
    sides, the wide kernel's plain version: within 5e-3, the JAX package's
    own ``bigru_pallas_vs_fused`` gate (a bf16 output ulp near 1 is 4e-3)."""
    before = birnn_kernel.WIDE_GRU_KERNEL.launches
    got = birnn_kernel.bigru(jax_bigru["tf"], jax_bigru["tb"], torch.from_numpy(jax_bigru["x"]),
                             torch.bfloat16).numpy()
    assert birnn_kernel.WIDE_GRU_KERNEL.launches == before  # a CPU tensor launches nothing
    assert np.abs(got - jax_bigru["pallas"]).max() <= 5e-3


# -- the decode kernel (#6) past H 1024 ----------------------------------------


def _widths(H, A=128, D=512):
    return dk.Widths(H=H, D=D, P1=256, P2=256, A=A, mel=80, conv_k=31, conv_c=32)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("H, A", [(1152, 128), (1536, 128), (1536, 640), (1664, 128),
                                  (2048, 128), (1152, 1024), (2048, 1024)])
def test_decode_layout_past_h1024(H, A, quantized):
    """Past H 1024 a gate block owns up to 16 units (three or four m-tiles)
    and its weights outgrow it (or, at H 1152 bf16 A 128, not quite): the
    layout keeps resident the windows that fit and streams the rest, and a
    launch of 16 rows at S 208 fits, with thousands of positions for one
    row. Every width the JAX gate admits up to H 2048 in int8, the 80 MB
    rule's H 1664 in bf16, attention 1024."""
    w = _widths(H, A)
    lay = dk.decode_layout(H, N_SM)
    assert lay["mt"] in (3, 4) and lay["grid"] <= N_SM
    assert dk._shape_reason(H, 512, (256, 256), 208, A, 80, 32, 31, quantized) is None
    rows = dk.group_rows(208, w, quantized, N_SM, MAX_SMEM)
    assert rows >= (6 if (H, A, quantized) == (1152, 128, False) else 16)
    for B in (1, rows):
        got = dk.layout_bytes(B, 208, w, quantized, N_SM, MAX_SMEM)
        assert got["fits"] and got["total"] <= MAX_SMEM
    win = 64 if quantized else 32
    nw0 = -(-(256 + 512 + H) // win)
    nw1 = -(-(2 * H + 512) // win)
    got = dk.layout_bytes(16, 208, w, quantized, N_SM, MAX_SMEM)
    assert 0 <= got["r0"] <= nw0 and 0 <= got["r1"] <= (nw1 if quantized else 0)
    assert dk.max_positions(w, quantized, N_SM, MAX_SMEM) >= 1000


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_decode_layout_at_production_width_keeps_every_window(quantized):
    """The production width (H 1024, A 128) keeps today's layout: every
    window resident (bf16: layer 0's), nothing streamed past it."""
    w = _widths(1024, 128, 768)
    got = dk.layout_bytes(4, 48, w, quantized, N_SM, MAX_SMEM)
    win = 64 if quantized else 32
    assert got["r0"] == -(-(256 + 768 + 1024) // win)
    assert got["r1"] == (-(-(2 * 1024 + 768) // win) if quantized else 0)
    assert dk.decode_layout(1024, N_SM)["mt"] == 2


def test_decode_shape_rule_past_h1024():
    """Taken: attention wider than 512 and gate products deeper than a
    staging piece; refused: more than 16 units a gate block (H 2064)."""
    assert dk._shape_reason(1536, 512, (256, 256), 64, 1024, 80, 32) is None
    assert dk._shape_reason(2048, 512, (256, 256), 64, 128, 80, 32) is None  # K1 4608
    reason = dk._shape_reason(2064, 512, (256, 256), 64, 128, 80, 32)
    assert "64 gate rows a block" in reason and "2048" in reason


# -- the mel front-end (#1) at any n_fft ---------------------------------------


@pytest.mark.parametrize("n_fft, route, global_mode", [
    (4, "fft", False), (32, "fft", False), (128, "fft", False), (8192, "fft", False),
    (16384, "fft", False), (32768, "fft", True), (65536, "fft", True),
    (2, "dft", False), (6, "dft", False), (6000, "dft", False), (16603, "dft", False),
    (16604, "dft", True), (24000, "dft", True),
])
def test_mel_plan(n_fft, route, global_mode):
    assert mel_kernel.plan(n_fft) == (route, global_mode)
    assert (mel_kernel.smem_bytes(n_fft) > MAX_SMEM) == global_mode
    assert mel_kernel.mel_shape_reason(n_fft, 1) is None
    assert mel_kernel.mel_shape_reason(n_fft, n_fft) is None


@pytest.fixture(scope="module")
def jax_mel():
    """The JAX package's mel front-end on one clip, once for the module:
    ``dsp.melspectrogram`` at n_fft 32, 128 and 8192 and
    ``melspectrogram_pallas`` in interpret mode at 128."""
    rng = np.random.default_rng(8192)
    out = {}
    for n_fft in (32, 128, 8192):
        hop = n_fft // 4
        cfg = dsp.DSPConfig(22050, n_fft, hop, 80, 0.0, None, 0.97, -100.0, 20.0, 1.5, 60)
        wav = (rng.standard_normal((2, hop * 12)) * 0.3).astype(np.float32)
        jcfg = jdsp.DSPConfig(**{f: getattr(cfg, f) for f in jdsp.DSPConfig.__dataclass_fields__})
        out[n_fft] = {"cfg": cfg, "wav": wav,
                      "fft": np.asarray(jdsp.melspectrogram(jnp.asarray(wav), jcfg))}
        if n_fft == 128:
            out[n_fft]["pallas"] = np.asarray(jmel.melspectrogram_pallas(
                jnp.asarray(wav), jcfg, interpret=True))
    return out


@pytest.mark.parametrize("n_fft", [32, 128, 8192])
def test_plain_mel_matches_jax_melspectrogram(jax_mel, n_fft):
    """The kernel's plain version (the f32 DFT matmul) within 1e-4 of the
    JAX FFT route, the front-end's budget."""
    case = jax_mel[n_fft]
    got = mel_kernel.melspectrogram_fused(torch.from_numpy(case["wav"]), case["cfg"]).numpy()
    assert got.shape == case["fft"].shape
    assert np.abs(got - case["fft"]).max() <= 1e-4
    if n_fft == 8192:  # its DFT table is 268 MB: not kept past this test
        mel_kernel._operands.cache_clear()
        mel_kernel._device_operands.cache_clear()


def test_plain_mel_past_its_dft_table_matches_jax_melspectrogram():
    """Past n_fft 8192 the plain version takes an f32 rfft in place of the
    DFT table (gigabytes there): still within 1e-4 of the JAX FFT route."""
    n_fft = 16384
    cfg = dsp.DSPConfig(22050, n_fft, n_fft // 4, 80, 0.0, None, 0.97, -100.0, 20.0, 1.5, 60)
    wav = (np.random.default_rng(16384).standard_normal((1, n_fft * 2)) * 0.3).astype(np.float32)
    jcfg = jdsp.DSPConfig(**{f: getattr(cfg, f) for f in jdsp.DSPConfig.__dataclass_fields__})
    want = np.asarray(jdsp.melspectrogram(jnp.asarray(wav), jcfg))
    got = mel_kernel.melspectrogram_fused(torch.from_numpy(wav), cfg).numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-4


def test_plain_mel_at_128_matches_the_pallas_kernel_in_interpret_mode(jax_mel):
    case = jax_mel[128]
    got = mel_kernel.melspectrogram_fused(torch.from_numpy(case["wav"]), case["cfg"]).numpy()
    assert got.shape == case["pallas"].shape
    assert np.abs(got - case["pallas"]).max() <= 1e-4
