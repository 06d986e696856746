"""The kernels at every batch and width the reference's gates admit, on the
CPU: the launch plans the wrappers compute for an H100 (the LSTM backward's
row groups, the BiGRU's route and the wide route's rows, the decode
kernel's layout past H 1024, the mel front-end's route and mode at any
n_fft), the wrappers' choice of entry point and launch counts on a
pretended card, and the plain versions that the card's kernels are held to
at those widths against the JAX package: the BiGRU at H 256 against
``bigru_fused`` (f32) and ``bigru_pallas(..., interpret=True)`` (bf16), the
mel front-end at n_fft 32, 128 and 8192 against ``dsp.melspectrogram``,
and at 128 against ``melspectrogram_pallas`` in interpret mode; the dense
Griffin-Lim's tiling past n_fft 2048 (more column slices than SMs, frame
offsets in groups, a frame's columns in pieces) emulated index for index
against the plain overlap-add, and its plain version at 2304 / 1152
against ``griffin_lim_pallas(..., interpret=True)``. The kernels themselves
run only on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.audio import dsp as jdsp
from multi_speaker_tts_tpu.ops import birnn_pallas
from multi_speaker_tts_tpu.ops import griffin_lim_kernel as jgk
from multi_speaker_tts_tpu.ops import gru as jgru
from multi_speaker_tts_tpu.ops import mel_kernel as jmel
from multi_speaker_tts_tpu.ops.stft_matmul import _pallas_gl_max_batch
from multi_speaker_tts_tpu_torch.audio import dsp
from multi_speaker_tts_tpu_torch.ops import _build, birnn_kernel, gru, lstm_kernel, mel_kernel
from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk
from multi_speaker_tts_tpu_torch.ops import griffin_lim_kernel as gk
from multi_speaker_tts_tpu_torch.ops import stft_matmul

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
    route; both take every H % 16 here, the wide route's forward and
    backward 32 rows a launch (past H 1,184 the forward in its streamed
    build), each launch's block within the card's bytes."""
    shapes = ((9, 32, 3 * H), ((H, 3 * H), (H, 3 * H)))
    assert birnn_kernel.bigru_shape_reason(*shapes) is None
    assert birnn_kernel.bigru_bwd_shape_reason(*shapes) is None
    assert birnn_kernel.bigru_route(H) == ("narrow" if H <= 192 else "wide")
    if H > 192:
        U, _ = _build.recurrence_grid(2, H, N_SM)
        for bwd in (False, True):
            rows = birnn_kernel.wide_rows(bwd, H, 32)
            assert rows == 32 or (H > 1024 and rows >= 1)
            lay = birnn_kernel.wide_layout(bwd, H, rows)
            assert lay["U"] == U and lay["fits"] and lay["bytes"] <= MAX_SMEM


def test_bigru_wide_route_limit_and_row_groups():
    assert birnn_kernel.wide_max_h() == 4880
    assert all(birnn_kernel.bigru_shape_reason((4, 2, 3 * H), [(H, 3 * H)] * 2) is None
               for H in range(208, 4881, 16))
    reason = birnn_kernel.bigru_shape_reason((4, 2, 3 * 4896), [(4896, 3 * 4896)] * 2)
    assert "16 <= H <= 4880" in reason
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
    staging piece, and in int8 more than 16 units a gate block (H 2064, in
    passes); refused in bf16 only: more than 16 units a gate block."""
    assert dk._shape_reason(1536, 512, (256, 256), 64, 1024, 80, 32) is None
    assert dk._shape_reason(2048, 512, (256, 256), 64, 128, 80, 32) is None  # K1 4608
    assert dk._shape_reason(2064, 512, (256, 256), 64, 128, 80, 32) is None
    reason = dk._shape_reason(2064, 512, (256, 256), 64, 128, 80, 32, quantized=False)
    assert "64 gate rows a block in bf16" in reason and "2048" in reason


# -- the decode kernel (#6) in int8 past H 2048 ---------------------------------


@pytest.mark.parametrize("H", [2176, 2304, 3072, 4096, 6144, 8192])
@pytest.mark.parametrize("A", [128, 640, 1024])
def test_decode_int8_layout_past_h2048(H, A):
    """Past 16 units a gate block the int8 kernel covers 4U gate rows in
    passes of four m-tiles (the multi-pass build): a launch of one row fits
    at S 256 and far past it (the JAX gate admits S <= 256 at any int8
    width), up to 16 rows at S 208 where the staged rows leave room, and
    the layout keeps resident only the windows that fit (every weight row
    of a block outgrows it)."""
    w = _widths(H, A)
    lay = dk.decode_layout(H, N_SM)
    assert lay["mt"] > dk.MAX_M_TILES and lay["grid"] <= N_SM
    assert dk.max_positions(w, True, N_SM, MAX_SMEM) >= 256
    assert dk._shape_reason(H, 512, (256, 256), 256, A, 80, 32, 31, True) is None
    assert dk._shape_reason(H, 512, (256, 256), None, A, 80, 32, 31, False) is not None
    one = dk.layout_bytes(1, 256, w, True, N_SM, MAX_SMEM)
    assert one["fits"] and one["total"] <= MAX_SMEM
    nw0, nw1 = -(-(256 + 512 + H) // 64), -(-(2 * H + 512) // 64)
    assert one["r0"] < nw0 and one["r1"] < nw1
    assert 1024 * lay["mt"] * (one["r0"] + one["r1"]) < MAX_SMEM
    rows = dk.group_rows(208, w, True, N_SM, MAX_SMEM)
    assert rows >= (16 if H <= 4096 else 8)
    assert not dk.layout_bytes(1, 256, w, False, N_SM, MAX_SMEM)["fits"]


def test_decode_int8_passes_keep_the_production_layouts():
    """Up to H 2048 the layouts keep four m-tiles at most (no multi-pass
    region, wq resident), so the production and wide builds run as they
    did."""
    for H, A in ((1024, 128), (1536, 640), (2048, 1024)):
        assert dk.decode_layout(H, N_SM)["mt"] <= dk.MAX_M_TILES
        w = _widths(H, A)
        for q in (False, True):
            assert dk.layout_bytes(16, 208, w, q, N_SM, MAX_SMEM)["fits"]


# -- the BiGRU (#5, #5r, #10) past H 1,248 -------------------------------------


@pytest.mark.parametrize("H", [1280, 1408, 1536, 2048, 2560, 3072, 4096])
@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
def test_bigru_streamed_layout_past_h1248(H, bwd):
    """Where a block's W_hh slice does not hold 32 rows the streamed build
    keeps the n-tiles that fit resident and reads the rest from L2: a
    launch of 32 rows fits at every JAX width up to 4096 a direction, the
    resident tiles fill what the partial tiles and the rows' state leave,
    and one more tile would not fit."""
    card = _build.H100
    rows = birnn_kernel.wide_rows(bwd, H, 32, card)
    assert rows == 32
    lay = birnn_kernel.wide_layout(bwd, H, rows, card)
    assert lay["stream"] and lay["fits"] and lay["bytes"] <= MAX_SMEM
    assert 0 <= lay["ntr"] <= lay["nt"]
    U = lay["U"]
    assert lay["nt"] == _build.round_up(U if bwd else 3 * U, 8) // 8
    assert lay["bytes"] == birnn_kernel.wide_smem_bytes(bwd, U, H, rows, 8 * lay["ntr"])
    if lay["ntr"] < lay["nt"]:
        assert birnn_kernel.wide_smem_bytes(bwd, U, H, rows, 8 * lay["ntr"] + 8) > MAX_SMEM
    if H >= 2048:
        assert lay["ntr"] < lay["nt"]  # some of the slice streams
    groups = birnn_kernel.wide_row_groups(bwd, H, 40, card)
    assert [i for g in groups for i in range(40)[g]] == list(range(40))


@pytest.mark.parametrize("H", [256, 512, 1024])
def test_bigru_resident_layout_below_h1200_unchanged(H):
    """The wide route's widths up to H 1024 keep the whole slice resident,
    32 rows a launch, in both directions."""
    for bwd in (False, True):
        lay = birnn_kernel.wide_layout(bwd, H, 32)
        assert not lay["stream"] and lay["ntr"] == lay["nt"]
        U, _ = _build.recurrence_grid(2, H, N_SM)
        assert lay["bytes"] == birnn_kernel.wide_smem_bytes(bwd, U, H, 32)


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


# -- the dense Griffin-Lim (#7) past n_fft 2048 --------------------------------


def _gl_shapes(lo, hi):
    """(n_fft, hop, T) for every 256-multiple n_fft in [lo, hi) and every
    hop the JAX dispatch admits (a 128-multiple, n_fft / hop even), at the
    largest T its cap takes one row."""
    out = []
    for n_fft in range(lo, hi, 256):
        for k in range(2, n_fft // 128 + 1, 2):
            if n_fft % k or (n_fft // k) % 128:
                continue
            hop = n_fft // k
            if _pallas_gl_max_batch(2, n_fft, hop) < 1:
                continue
            T, step = 2, 1024
            while step:
                if _pallas_gl_max_batch(T + step, n_fft, hop) >= 1:
                    T += step
                else:
                    step //= 2
            out.append((n_fft, hop, T))
    return out


@pytest.mark.parametrize("lo, hi", [(2304, 4352), (4352, 8448), (8448, 16640), (16640, 33024),
                                    (33024, 65792)])
def test_dense_plan_at_every_jax_shape(lo, hi):
    """Wherever the JAX gate launches its kernel (one row at its cap's
    largest T) the kernel has a tiling on an H100: within the block's
    bytes and the card's SMs, a group's offsets within a 64-column tile,
    the groups covering every offset, an inverse tile of at most 128
    frames, a forward piece that divides hop in 128-multiples, slabs in
    boxes of at most 256 rows."""
    shapes = _gl_shapes(lo, hi)
    assert shapes
    for n_fft, hop, T in shapes:
        p = gk.dense_plan(1, T, n_fft, hop)
        k = n_fft // hop
        assert p["smem"] <= MAX_SMEM and 1 <= p["blocks"] <= N_SM, (n_fft, hop)
        assert p["qg"] * p["cs"] <= gk.TILE_N and p["qg"] * p["ng"] >= k > p["qg"] * (p["ng"] - 1)
        assert p["m_out"] + p["qg"] - 1 <= gk.MAX_M and p["rt"] * p["m_out"] >= T + k - 1
        assert hop % p["pw"] == 0 and p["pw"] % 128 == 0 and p["ft"] * p["mf"] >= T
        rows = gk.slab_rows(p["mf"], k)
        assert rows % 8 == 0 and rows // -(-rows // gk.MAX_BOX) <= gk.MAX_BOX
        if p["n_cs"] > N_SM:
            assert p["blocks"] == N_SM and not p["resident"]


def test_dense_plan_past_2048_examples():
    """The shapes of the card's rows: 4096 / 512 keeps whole frames and one
    slice a block; 8192 / 4096 takes each frame's 4096 columns in two
    pieces; 16384 / 2048 and 32768 / 4096 have more slices (256, 512) than
    SMs; 65536 / 128 has 512 offsets in 8 groups of 64, a slice a column;
    which of them take the wide instantiation."""
    p = gk.dense_plan(1, 304, 4096, 512)
    assert (p["n_cs"], p["ng"], p["pw"], p["blocks"]) == (64, 1, 512, 128)
    assert gk.dense_plan(1, 157, 8192, 4096)["pw"] == 2048
    for n_fft, hop, T, n_cs in ((16384, 2048, 79, 256), (32768, 4096, 40, 512)):
        p = gk.dense_plan(1, T, n_fft, hop)
        assert p["n_cs"] == n_cs and p["blocks"] == N_SM
    p = gk.dense_plan(1, 20, 65536, 128)
    assert (p["cs"], p["qg"], p["ng"], p["n_cs"]) == (1, 64, 8, 128)
    assert p["m_out"] + 63 <= gk.MAX_M
    # The wide instantiation only where a shape needs it: every shape the
    # kernel took up to n_fft 2048 (and 4096 / 512, 2304 / 1152) keeps the
    # production one.
    wide = {(n, h): gk.dense_plan(1, T, n, h)["wide"]
            for n, h, T in ((4096, 512, 304), (2304, 1152, 6), (8192, 4096, 157),
                            (16384, 2048, 79), (8192, 128, 9), (65536, 128, 20))}
    assert wide == {(4096, 512): 0, (2304, 1152): 0, (8192, 4096): 1, (16384, 2048): 1,
                    (8192, 128): 1, (65536, 128): 1}
    assert not any(gk.dense_plan(B, T, n, h)["wide"] for n in range(256, 2049, 256)
                   for h in range(128, n, 128) if n % h == 0 and (n // h) % 2 == 0
                   for B, T in ((4, 128), (1, 1000)))


@pytest.mark.parametrize("n_fft, hop", [(2304, 1152), (4096, 512), (8192, 128), (8704, 128),
                                        (16384, 2048)])
def test_dense_inverse_columns_cover_the_synthesis_columns(n_fft, hop):
    """Every synthesis column of [Vr; Vi] lies in exactly one (slice,
    group) column of the packed inverse matrix, at local column q' cs + c
    for frame offset g qg + q' and hop-column s cs + c."""
    cols = gk.inverse_columns(n_fft, hop)
    cs, qg, ng = gk.slice_widths(n_fft, hop)
    assert cols.shape == (hop // cs * ng, gk.TILE_N)
    used = cols[cols >= 0]
    assert np.array_equal(np.sort(used), np.arange(n_fft))
    s, g = 3 % (hop // cs), ng - 1
    qq = (n_fft // hop - 1) - g * qg
    assert cols[s * ng + g, qq * cs] == (g * qg + qq) * hop + s * cs


def _emulate_inverse(p, X, rny, vny, wsum, T, hop):
    """The kernel's inverse phase, unit for unit and group for group (the
    products replaced by the frames' synthesis X (T, n_fft), which the
    product computes column for column): rows (nr, hop)."""
    k, cs, qg, ng = p["k"], p["cs"], p["qg"], p["ng"]
    cols = gk.inverse_columns(k * hop, hop)
    out = np.zeros((p["nr"], hop), np.float64)
    covered = np.zeros((p["nr"], hop), np.int64)
    for u in range(p["n_cs"] * p["rt"]):  # B 1
        sl, v = u % p["n_cs"], u // p["n_cs"]
        r0 = v * p["m_out"]
        rows = min(p["m_out"], p["nr"] - r0)
        acc = np.zeros((rows, cs))
        for g in range(ng):
            q0 = g * qg
            nq = min(qg, k - q0)
            f0, M = r0 - q0 - (qg - 1), rows + qg - 1
            if f0 + M <= 0 or f0 >= T:
                continue
            c_idx = cols[sl * ng + g]
            S = np.zeros((M, gk.TILE_N))
            for i in range(M):
                if 0 <= f0 + i < T:
                    S[i] = np.where(c_idx >= 0, X[f0 + i][np.maximum(c_idx, 0)], 0.0)
            rn = np.array([rny[f0 + i] if 0 <= f0 + i < T else 0.0 for i in range(M)])
            for j in range(rows):
                for c in range(cs):
                    for q in range(nq):
                        fi = j + qg - 1 - q
                        col = (q0 + q) * hop + sl * cs + c
                        acc[j, c] += S[fi, q * cs + c] + rn[fi] * vny[col]
        for j in range(rows):
            for c in range(cs):
                r, col = r0 + j, sl * cs + c
                out[r, col] = acc[j, c] * wsum[r, col]
                covered[r, col] += 1
    assert (covered == 1).all()
    return out


@pytest.mark.parametrize("n_fft, hop, T", [(2304, 1152, 6), (8192, 128, 3), (8704, 128, 5),
                                           (16384, 128, 2)])
def test_dense_tiling_emulated_is_the_plain_overlap_add(n_fft, hop, T):
    """The inverse units (slices in turn, groups of 64 offsets, groups with
    no frame skipped) give every signal row the plain version's
    overlap-add, and the forward pieces' k-slices cover the frame once, each
    within its piece's columns."""
    p = gk.dense_plan(1, T, n_fft, hop)
    rng = np.random.default_rng(n_fft + hop)
    X = rng.standard_normal((T, n_fft))
    rny, vny = rng.standard_normal(T), rng.standard_normal(n_fft)
    k = n_fft // hop
    wsum = rng.random((p["nr"], hop)) + 0.5
    want = np.zeros((p["nr"], hop))
    for t in range(T):
        for q in range(k):
            want[t + q] += X[t, q * hop:(q + 1) * hop] + rny[t] * vny[q * hop:(q + 1) * hop]
    want *= wsum
    got = _emulate_inverse(p, X, rny, vny, wsum, T, hop)
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    spr, nks = p["pw"] // 128, k * p["pw"] // 128
    seen = []
    for pc in range(hop // p["pw"]):
        for i in range(nks):
            ks = (i // spr) * (hop // 128) + pc * spr + i % spr
            q = ks * 128 // hop
            assert 0 <= ks * 128 - q * hop - pc * p["pw"] < p["pw"]
            seen.append(ks)
    assert sorted(seen) == list(range(n_fft // 128))


def test_plain_dense_at_2304_matches_the_pallas_kernel_in_interpret_mode():
    """The plain version at the smallest new shape (2304 / 1152, T 6, two
    iterations, f32 products) against ``griffin_lim_pallas`` in interpret
    mode, to f32 summation order (the existing shapes' 1e-4)."""
    n_fft, hop, T = 2304, 1152, 6
    mag = (np.random.default_rng(2304).random((2, T, n_fft // 2 + 1)) ** 2).astype(np.float32)
    want = np.asarray(jgk.griffin_lim_pallas(jnp.asarray(mag), n_fft, hop, 2, interpret=True,
                                             compute_dtype="float32"))
    got = gk.griffin_lim_dense(torch.from_numpy(mag), n_fft, hop, 2,
                               compute_dtype=torch.float32).numpy()
    assert got.shape == want.shape == (2, hop * (T - 1))
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4


@pytest.mark.parametrize("n_fft, hop, T", [(4096, 512, 304), (16384, 2048, 79),
                                           (32768, 4096, 40)])
def test_dense_route_and_chunks_past_2048(n_fft, hop, T):
    """At the JAX cap's T the route is the dense kernel; past L2 the rows a
    call are those whose working set fits the device budget (every batch
    the reference admits in one call), not one."""
    assert stft_matmul.gl_route(3, n_fft, hop, T, hop * (T - 1), True, 1, 0.0) == "dense"
    assert stft_matmul.gl_max_batch(T, n_fft, 0.0, "dense") >= 8
