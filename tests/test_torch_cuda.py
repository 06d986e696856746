"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an sm_90a card and ``nvcc`` and skip without
them (the kernels have no CPU mode; the CPU tests hold the plain versions
against the JAX package). On the card: ``python -m pytest -m cuda
tests/test_torch_cuda.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from multi_speaker_tts_tpu_torch.ops import _build

    try:
        _build._nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _lstm(rng, D, H, dev, scale=0.1):
    return LSTMParams(*(torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32)).to(dev)
                        for s in ((D, 4 * H), (H, 4 * H), (4 * H,))))


@pytest.mark.parametrize("T", [1, 2, 133, 862])
@pytest.mark.parametrize("hop_div", [4, 8])
@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048, 4096])
def test_mel_kernel(dev, n_fft, hop_div, T):
    """The FFT kernel within 1e-4 of the plain f32 DFT matmul on noise, a
    silent clip and a full-scale (clipped) clip, B 1-4 across the cases; a
    repeat is bit-equal; one launch a call. The padded signals are made
    directly (T = 1 is a clip of no samples before padding), with rows of
    (T - 1) hop + n_fft + T % 3 samples: rows past the first start off the
    16-byte grid, so both of the kernel's frame loads run."""
    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.ops import mel_kernel

    hop = n_fft // hop_div
    B = 1 + (n_fft // 256 + hop_div + T) % 4
    cfg = dsp.DSPConfig(22050, n_fft, hop, 80, 0.0, None, 0.97, -100.0, 20.0, 1.5, 60)
    rng = np.random.default_rng(n_fft + T)
    Lp = (T - 1) * hop + n_fft + T % 3
    clips = {"noise": rng.standard_normal((B, Lp)) * 0.3,
             "silent": np.zeros((B, Lp)),
             "full scale": np.clip(3.0 * rng.standard_normal((B, Lp)), -1.0, 1.0)}
    for kind, sig in clips.items():
        y_pad = torch.from_numpy(sig.astype(np.float32)).to(dev)
        before = mel_kernel.KERNEL.launches
        got = mel_kernel.melspectrogram_kernel(y_pad, T, cfg)
        again = mel_kernel.melspectrogram_kernel(y_pad, T, cfg)
        torch.cuda.synchronize()
        assert mel_kernel.KERNEL.launches == before + 2, kind
        assert torch.equal(got, again), kind
        want = mel_kernel.melspectrogram_plain(y_pad, T, cfg)
        assert got.shape == want.shape == (B, T, 80)
        assert (got - want).abs().max().item() <= 1e-4, kind  # f32, no TF32
        if kind == "silent":
            assert not got.any()


# The edges of the tensor-core tiling (B in m-tiles of 16, 4U gate columns
# in n-tiles of 8, K in k-steps of 16 or chunks of 32): B not a multiple of
# 16 (3, 17, 40), D = 72 (D + H not a multiple of 16), H = 776 (on 132 SMs
# the last of 130 blocks owns 2 of U = 6 units; BiLSTM: H = 136, 1 of 3),
# T = 1, and B = 100, four launches of up to 32 rows (the wrapper's row
# groups, ops/lstm_kernel.fwd_row_groups: one entry call a group; B = 40
# takes two).
LSTM_EDGES = [(17, 72, 64, 20), (40, 64, 776, 20), (3, 80, 768, 1), (100, 768, 768, 20)]


# With 40-100 rows at H = 768 some rows' bf16 rounding flips grow through
# the recurrence: there the plain bf16 version is itself 1.6-2.6e-2 from the
# plain f32 one (H100, 20 steps). Those wide edges (tolerance DRIFT) hold the
# kernel to half of that distance, at least 5e-3: nearer the plain bf16
# version than that version is to f32.
DRIFT = None


@pytest.mark.parametrize("T", [1, 2, 133, 862])
@pytest.mark.parametrize("n_fft, hop", [(800, 200), (1000, 250), (600, 150), (1200, 300),
                                        (4000, 1000)])
def test_mel_kernel_dft_route(dev, n_fft, hop, T):
    """The DFT route (an n_fft that is not a power of two) within 1e-4 of the
    plain f32 DFT matmul on noise, a silent clip and a full-scale clip, B
    1-4; a repeat is bit-equal; one launch a call on its own count, none on
    the FFT route's."""
    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.ops import mel_kernel

    B = 1 + (n_fft // 200 + T) % 4
    cfg = dsp.DSPConfig(22050, n_fft, hop, 80, 0.0, None, 0.97, -100.0, 20.0, 1.5, 60)
    rng = np.random.default_rng(n_fft + T)
    Lp = (T - 1) * hop + n_fft + T % 3
    clips = {"noise": rng.standard_normal((B, Lp)) * 0.3,
             "silent": np.zeros((B, Lp)),
             "full scale": np.clip(3.0 * rng.standard_normal((B, Lp)), -1.0, 1.0)}
    for kind, sig in clips.items():
        y_pad = torch.from_numpy(sig.astype(np.float32)).to(dev)
        before = mel_kernel.KERNEL.launches, mel_kernel.DFT_KERNEL.launches
        got = mel_kernel.melspectrogram_kernel(y_pad, T, cfg)
        again = mel_kernel.melspectrogram_kernel(y_pad, T, cfg)
        torch.cuda.synchronize()
        assert (mel_kernel.KERNEL.launches, mel_kernel.DFT_KERNEL.launches) == (
            before[0], before[1] + 2), kind
        assert torch.equal(got, again), kind
        want = mel_kernel.melspectrogram_plain(y_pad, T, cfg)
        assert got.shape == want.shape == (B, T, 80)
        assert (got - want).abs().max().item() <= 1e-4, kind  # f32, no TF32
        if kind == "silent":
            assert not got.any()


def test_mel_auto_takes_the_dft_route_on_the_card(dev):
    """``melspectrogram_auto`` at n_fft 800 / hop 200 (the JAX rule's fused
    route) launches the DFT route and agrees with the CPU's plain version."""
    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.ops import mel_kernel

    cfg = dsp.DSPConfig(16000, 800, 200, 80, 0.0, None, 0.97, -100.0, 20.0, 1.5, 60)
    wav = (np.random.default_rng(3).standard_normal((2, 200 * 40)) * 0.3).astype(np.float32)
    before = mel_kernel.DFT_KERNEL.launches
    got = dsp.melspectrogram_auto(torch.from_numpy(wav).to(dev), cfg)
    torch.cuda.synchronize()
    assert mel_kernel.DFT_KERNEL.launches == before + 1
    want = dsp.melspectrogram_auto(torch.from_numpy(wav), cfg)
    assert (got.cpu() - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("B, D, H, T, tol", [
    (3, 80, 768, 20, 5e-3), (5, 768, 768, 20, 5e-3), (40, 96, 128, 20, 5e-3),
    (17, 72, 64, 20, 5e-3), (40, 64, 776, 20, DRIFT), (3, 80, 768, 1, 5e-3),
    (100, 768, 768, 20, DRIFT)])
def test_lstm_layer_kernel(dev, B, D, H, T, tol):
    from multi_speaker_tts_tpu_torch.ops import lstm_kernel

    rng = np.random.default_rng(B)
    p = _lstm(rng, D, H, dev)
    x = torch.from_numpy(rng.normal(size=(T, B, D)).astype(np.float32)).to(dev, torch.bfloat16)
    got = lstm_kernel.lstm_seq_layer_kernel(p, x)
    want = lstm_kernel.lstm_seq_layer_plain(p, x, torch.bfloat16)

    def dist(a, b):
        return max((u.float() - v.float()).abs().max().item() for u, v in zip(a, b))

    if tol is DRIFT:
        tol = max(5e-3, 0.5 * dist(want, lstm_kernel.lstm_seq_layer_plain(p, x, torch.float32)))
    # bf16 operands and outputs, f32 sums in another order (KERNEL_PARITY 5e-3).
    for a, b in zip(got, want):  # ys, h, c
        assert (a.float() - b.float()).abs().max().item() <= tol


BILSTM_EDGES = [(17, 20, 136), (3, 1, 256), (100, 12, 256)]


@pytest.mark.parametrize("B, S, H", [(4, 33, 256), *BILSTM_EDGES])
def test_bilstm_kernel(dev, B, S, H):
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel

    rng = np.random.default_rng(1)
    pf, pb = _lstm(rng, 64, H, dev), _lstm(rng, 64, H, dev)
    x = torch.from_numpy(rng.normal(size=(B, S, 64)).astype(np.float32)).to(dev)
    gxf, gxb = birnn_kernel.bilstm_hoist(pf, pb, x, torch.bfloat16)
    ysf, ysb = birnn_kernel.bilstm_recurrence_kernel(gxf, gxb, pf.w_hh, pb.w_hh)
    rf, rb = birnn_kernel.bilstm_recurrence_plain(gxf, gxb, pf.w_hh, pb.w_hh, torch.bfloat16)
    assert (ysf.float() - rf.float()).abs().max().item() <= 5e-3
    assert (ysb.float() - rb.float()).abs().max().item() <= 5e-3


@pytest.mark.parametrize("B, T", [(1, 64), (3, 37)])
def test_griffin_lim_kernel(dev, B, T):
    from multi_speaker_tts_tpu_torch.ops import griffin_lim_staged as gl

    rng = np.random.default_rng(T)
    mag = torch.from_numpy(rng.random((B, T, 513)).astype(np.float32) ** 2).to(dev)
    ms = gl.staged_magnitudes(mag, torch.bfloat16)
    got = gl.griffin_lim_staged_kernel(ms, 256, 8)
    want = gl.griffin_lim_staged_plain(ms, 256, 8, torch.bfloat16)
    # bf16 leaf operands: last-bit differences of the f32 sums flip operand
    # roundings; 8 iterations keep that within 2% of the peak.
    assert ((got - want).abs().max() / want.abs().max()).item() <= 2e-2


@pytest.mark.parametrize("B, T", [(1, 64), (3, 37)])
def test_griffin_lim_kernel_momentum(dev, B, T):
    from multi_speaker_tts_tpu_torch.ops import griffin_lim_staged as gl

    rng = np.random.default_rng(T + 1)
    mag = torch.from_numpy(rng.random((B, T, 513)).astype(np.float32) ** 2).to(dev)
    ms = gl.staged_magnitudes(mag, torch.bfloat16)
    before = (gl.KERNEL.launches, gl.MOM_KERNEL.launches)
    got = gl.griffin_lim_staged(mag, 1024, 256, 8, momentum=0.99)
    assert (gl.KERNEL.launches, gl.MOM_KERNEL.launches) == (before[0], before[1] + 1)
    want = gl.griffin_lim_staged_plain(ms, 256, 8, torch.bfloat16, momentum=0.99)
    # As the plain mode, plus bf16 previous projections on both sides.
    assert ((got - want).abs().max() / want.abs().max()).item() <= 2e-2
    # The plain mode is unchanged by the momentum mode's arguments.
    plain = gl.griffin_lim_staged_kernel(ms, 256, 8)
    assert torch.equal(plain, gl.griffin_lim_staged_kernel(ms, 256, 8, 0.0))


# The edges of the one-launch design: n_fft 512 / 2048 (the 2048 slices
# stream through the ring instead of staying resident), T not a multiple of
# the inverse and forward tiles (47, 130), a batch above one tile of rows
# (B 6 at T 128: the inverse units of several utterances share a column
# slice's blocks), hop 1024 (k = 2) and k = 16 (hop 128 at n_fft 2048).
DENSE_CASES = [(2, 47), (2, 128), (6, 128), (3, 130)]


@pytest.mark.parametrize("momentum", [0.0, 0.99])
@pytest.mark.parametrize("B, T", DENSE_CASES)
@pytest.mark.parametrize("n_fft, hop", [(512, 128), (1024, 256), (2048, 256), (2048, 1024),
                                        (2048, 128)])
def test_griffin_lim_dense_kernel(dev, n_fft, hop, B, T, momentum):
    from multi_speaker_tts_tpu_torch.ops import griffin_lim_kernel as gk

    rng = np.random.default_rng(n_fft + T)
    mag = torch.from_numpy(rng.random((B, T, n_fft // 2 + 1)).astype(np.float32) ** 2).to(dev)
    before = gk.KERNEL.launches
    got = gk.griffin_lim_dense(mag, n_fft, hop, 4, momentum=momentum)
    again = gk.griffin_lim_dense(mag, n_fft, hop, 4, momentum=momentum)
    torch.cuda.synchronize()
    assert gk.KERNEL.launches == before + 2
    assert torch.equal(got, again)  # sums in a fixed order: the same input, the same output
    want = gk.griffin_lim_dense_plain(*gk.split_magnitude(mag, n_fft), n_fft, hop, 4,
                                      torch.bfloat16, momentum)
    assert got.shape == want.shape == (B, hop * (T - 1))
    # bf16 operands, f32 sums in another order, and an iteration that
    # amplifies the operand roundings they flip. The probe: the plain version
    # run on the CPU, the same arithmetic with its f32 sums in yet another
    # order. The relative L2 error stays within 2e-2 (the plain version
    # without its Nyquist term misses by more); the peak error within 2e-2
    # or, where the probe's peak moves further, 4x the probe's reading. (A
    # 1e-6 nudge of the input, chip_smoke.py's probe at 60 iterations, has not
    # spread yet at 4 and reads well below the kernel's sum-order difference.)
    probe = gk.griffin_lim_dense_plain(*(t.cpu() for t in gk.split_magnitude(mag, n_fft)),
                                       n_fft, hop, 4, torch.bfloat16, momentum).to(dev)

    def peak_rel(a):
        return ((a - want).abs().max() / want.abs().max()).item()

    assert (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item() <= 2e-2
    assert peak_rel(got) <= max(2e-2, 4 * peak_rel(probe)), (peak_rel(got), peak_rel(probe))


@pytest.mark.parametrize("B, T, n_fft, hop", [(4, 128, 1024, 256), (4, 128, 512, 128),
                                              (4, 128, 2048, 256), (32, 128, 1024, 256),
                                              (1, 1000, 1024, 256), (2, 2, 768, 128),
                                              # past 2048: pieces, slices past the SMs,
                                              # groups of offsets
                                              (2, 304, 4096, 512), (1, 157, 8192, 4096),
                                              (1, 79, 16384, 2048), (1, 40, 32768, 4096),
                                              (1, 5, 16384, 128), (1, 20, 65536, 128)])
def test_griffin_lim_dense_kernel_plan_is_the_mirrored_one(dev, B, T, n_fft, hop):
    """The tiling the kernel computes on this card is dense_plan's."""
    from multi_speaker_tts_tpu_torch.ops import griffin_lim_kernel as gk

    props = torch.cuda.get_device_properties(dev)
    smem = props.shared_memory_per_block_optin
    for momentum in (False, True):
        assert gk.kernel_plan(B, T, n_fft, hop, momentum) == gk.dense_plan(
            B, T, n_fft, hop, momentum, props.multi_processor_count, smem)


# Past n_fft 2048 (B, T, n_fft, hop): whole frames (2304, 4096), a frame's
# columns in two pieces (8192 / 4096), one hop-column a slice (8192 / 128,
# k 64), more slices than SMs (16384 / 2048), offsets in groups of 64
# (16384 / 128, k 128).
DENSE_WIDE = [(2, 6, 2304, 1152), (2, 47, 4096, 512), (1, 12, 8192, 4096), (1, 9, 8192, 128),
              (1, 10, 16384, 2048), (1, 5, 16384, 128)]


@pytest.mark.parametrize("B, T, n_fft, hop", DENSE_WIDE)
def test_griffin_lim_dense_kernel_past_2048(dev, B, T, n_fft, hop):
    """The dense kernel where the JAX gate launches its own past n_fft 2048:
    one launch a call, bit-equal on a repeat, and at 2 iterations (the
    iteration has not spread the operand roundings yet) within 2e-2 of the
    plain version's peak and relative L2."""
    from multi_speaker_tts_tpu_torch.ops import griffin_lim_kernel as gk

    rng = np.random.default_rng(n_fft + hop)
    mag = torch.from_numpy(rng.random((B, T, n_fft // 2 + 1)).astype(np.float32) ** 2).to(dev)
    before = gk.KERNEL.launches
    got = gk.griffin_lim_dense(mag, n_fft, hop, 2)
    again = gk.griffin_lim_dense(mag, n_fft, hop, 2)
    torch.cuda.synchronize()
    assert gk.KERNEL.launches == before + 2 and torch.equal(got, again)
    want = gk.griffin_lim_dense_plain(*gk.split_magnitude(mag, n_fft), n_fft, hop, 2,
                                      torch.bfloat16)
    assert got.shape == want.shape == (B, hop * (T - 1))
    assert (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item() <= 2e-2
    assert ((got - want).abs().max() / want.abs().max()).item() <= 2e-2
    gk._operands.cache_clear()
    gk._packed.cache_clear()


def test_griffin_lim_dense_kernel_is_one_launch_a_call(dev):
    """Every iteration runs inside one cooperative launch: the kernel's
    library counts one launch a call, plain and momentum, and the wrapper
    one call."""
    from multi_speaker_tts_tpu_torch.ops import griffin_lim_kernel as gk

    rng = np.random.default_rng(3)
    mag = torch.from_numpy(rng.random((2, 40, 513)).astype(np.float32)).to(dev)
    mp, mny = gk.split_magnitude(mag, 1024)
    for momentum in (0.0, 0.99):
        before = (gk.kernel_launch_count(), gk.KERNEL.launches)
        gk.griffin_lim_dense_kernel(mp, mny, 1024, 256, 8, momentum)
        torch.cuda.synchronize()
        assert (gk.kernel_launch_count(), gk.KERNEL.launches) == (before[0] + 1, before[1] + 1)


def test_griffin_lim_auto_routes_on_the_card(dev, monkeypatch):
    from multi_speaker_tts_tpu_torch.ops import griffin_lim_kernel as gk
    from multi_speaker_tts_tpu_torch.ops import griffin_lim_staged as gl
    from multi_speaker_tts_tpu_torch.ops import stft_matmul

    rng = np.random.default_rng(5)
    mag = torch.from_numpy(rng.random((3, 20, 513)).astype(np.float32)).to(dev)
    monkeypatch.delenv("GL_DENSE_KERNEL", raising=False)
    counts = (gl.KERNEL.launches, gk.KERNEL.launches)
    stft_matmul.griffin_lim_auto(mag, 1024, 256, 2, 256 * 19)
    assert (gl.KERNEL.launches, gk.KERNEL.launches) == (counts[0] + 1, counts[1])
    monkeypatch.setenv("GL_DENSE_KERNEL", "1")
    stft_matmul.griffin_lim_auto(mag, 1024, 256, 2, 256 * 19, momentum=0.99)
    assert (gl.KERNEL.launches, gk.KERNEL.launches) == (counts[0] + 1, counts[1] + 1)
    # Not eligible (hop 200): the GEMM route on the card, no kernel.
    wav = stft_matmul.griffin_lim_auto(mag[..., :401], 800, 200, 2, 200 * 19)
    assert wav.is_cuda and (gl.KERNEL.launches, gk.KERNEL.launches) == (counts[0] + 1,
                                                                       counts[1] + 1)
    # Eligible at n_fft 4096 (past the kernel's old 2048): the dense kernel,
    # one launch, no GEMM route.
    wide = torch.from_numpy(rng.random((2, 20, 2049)).astype(np.float32)).to(dev)
    wav = stft_matmul.griffin_lim_auto(wide, 4096, 256, 2, 256 * 19)
    torch.cuda.synchronize()
    assert gk.KERNEL.launches == counts[1] + 2
    assert wav.shape == (2, 256 * 19) and bool(torch.isfinite(wav).all())


def test_bigru_kernel(dev):
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel
    from multi_speaker_tts_tpu_torch.ops.gru import GRUParams

    rng = np.random.default_rng(2)

    def gru(D, H):
        return GRUParams(*(torch.from_numpy((rng.normal(size=s) * 0.1).astype(np.float32)).to(dev)
                           for s in ((D, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))))

    for B, T, H in ((4, 400, 128), (3, 24, 64)):
        pf, pb = gru(128, H), gru(128, H)
        x = torch.from_numpy(rng.normal(size=(B, T, 128)).astype(np.float32)).to(dev)
        gxf, gxb = birnn_kernel.bigru_hoist(pf, pb, x, torch.bfloat16)
        before = birnn_kernel.GRU_KERNEL.launches
        ysf, ysb = birnn_kernel.bigru_recurrence(gxf, gxb, pf, pb, torch.bfloat16)
        assert birnn_kernel.GRU_KERNEL.launches == before + 1
        rf, rb = birnn_kernel.bigru_recurrence_plain(gxf, gxb, pf, pb, torch.bfloat16)
        # bf16 operands and outputs, f32 sums in another order.
        assert (ysf.float() - rf.float()).abs().max().item() <= 5e-3
        assert (ysb.float() - rb.float()).abs().max().item() <= 5e-3
    with pytest.raises(NotImplementedError):
        birnn_kernel.bigru_recurrence(gxf.float(), gxb.float(), pf, pb, torch.float32)


@pytest.mark.parametrize("residuals", [False, True], ids=["plain", "residuals"])
@pytest.mark.parametrize("H", [16, 64, 128, 144, 192])
@pytest.mark.parametrize("B", [1, 4, 7, 8, 9, 16, 17, 32, 40])
def test_bigru_kernel_row_groups(dev, B, H, residuals):
    """One block per (direction, 8 rows): every batch size across the row
    groups, both modes, T 1, 2, 37 and 132, within 5e-3 of the plain bf16
    version; two launches on one input are bit-equal; the residuals feed
    the backward kernel, which holds within 1e-2 of the peak of its plain
    version, one launch a call, bit-equal on a repeat. H 144 and 192 keep
    part of W_hh in shared memory (and at H 192 the backward's residual ring
    has two slots)."""
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel
    from multi_speaker_tts_tpu_torch.ops.gru import GRUParams

    rng = np.random.default_rng(B * H)

    def gru(D):
        return GRUParams(*(torch.from_numpy((rng.normal(size=s) * 0.1).astype(np.float32)).to(dev)
                           for s in ((D, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))))

    pf, pb = gru(128), gru(128)
    for T in (1, 2, 37, 132):
        x = torch.from_numpy(rng.normal(size=(B, T, 128)).astype(np.float32)).to(dev)
        gxf, gxb = birnn_kernel.bigru_hoist(pf, pb, x, torch.bfloat16)
        kernel = birnn_kernel.GRU_RES_KERNEL if residuals else birnn_kernel.GRU_KERNEL
        before = kernel.launches
        got = birnn_kernel.bigru_recurrence_kernel(gxf, gxb, pf, pb, residuals)
        again = birnn_kernel.bigru_recurrence_kernel(gxf, gxb, pf, pb, residuals)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2
        want = birnn_kernel.bigru_recurrence_plain(gxf, gxb, pf, pb, torch.bfloat16, residuals)
        assert len(got) == len(want) == (6 if residuals else 2)
        for i, (a, b, c) in enumerate(zip(got, again, want)):  # ysf, ysb[, ghf, hpf, ghb, hpb]
            assert torch.equal(a, b) and a.shape == c.shape
            if i in (2, 4):  # gh, |gh| up to ~2: one flipped bf16 rounding is 1e-2 of it
                assert _rel_peak(a, c) <= 1e-2
            else:  # h, |h| < 1
                assert (a.float() - c.float()).abs().max().item() <= 5e-3
        if residuals:
            ysf, ysb, ghf, hpf, ghb, hpb = got
            dyf, dyb = (torch.from_numpy(rng.normal(size=(T, B, H)).astype(np.float32)).to(dev)
                        for _ in range(2))
            args = (gxf, ghf, hpf, gxb, ghb, hpb, pf.w_hh, pb.w_hh, dyf, dyb)
            before = birnn_kernel.GRU_BWD_KERNEL.launches
            dG = birnn_kernel.bigru_bwd(*args)
            torch.cuda.synchronize()
            assert birnn_kernel.GRU_BWD_KERNEL.launches == before + 1
            for a, b, c in zip(dG, birnn_kernel.bigru_bwd(*args),
                               birnn_kernel.bigru_bwd_plain(*args)):  # dGx, dGh per direction
                assert torch.equal(a, b) and a.shape == c.shape == (T, B, 3 * H)
                assert _rel_peak(a, c) <= 1e-2


GL_PROBES, GL_PROBE_MULTIPLE = 8, 4.0


@pytest.mark.parametrize("momentum", [0.0, 0.99], ids=["plain", "momentum"])
@pytest.mark.parametrize("T", [2, 17, 47, 128])
def test_griffin_lim_staged_kernel_shapes(dev, T, momentum):
    """The persistent staged kernel at the stream's T, a ragged tile, the
    shortest utterance and, at T = 128, the largest batch one call takes
    (gl_max_batch): within 2e-2 of the peak of the plain version at 8
    iterations, one launch a call, two launches bit-equal. The momentum
    iteration amplifies a flipped operand rounding further: at T = 128 and
    B = 32 moving the f32 magnitudes by 1e-6 of themselves moves the plain
    version's 8-iteration output by ~6% of its peak. So a momentum case
    takes chip_smoke.py's Griffin-Lim rule: the plain version also runs on
    the CPU (its f32 sums in another order) and on GL_PROBES such nudged
    inputs, and the kernel must land within max(2e-2, GL_PROBE_MULTIPLE x
    the probes' median distance from the plain version) of the peak from
    the plain version or one of its probes; besides, within 2e-2 of the
    peak of the plain version at 4 iterations and in relative L2 at 8. The
    readings are printed (``-s``)."""
    from multi_speaker_tts_tpu_torch.ops import griffin_lim_staged as gl
    from multi_speaker_tts_tpu_torch.ops import stft_matmul

    B = stft_matmul.gl_max_batch(T, momentum=momentum) if T == 128 else 3
    rng = np.random.default_rng(T)
    mag = torch.from_numpy(rng.random((B, T, 513)).astype(np.float32) ** 2).to(dev)
    ms = gl.staged_magnitudes(mag, torch.bfloat16)
    kernel = gl.MOM_KERNEL if momentum else gl.KERNEL
    before = kernel.launches
    got = gl.griffin_lim_staged_kernel(ms, 256, 8, momentum)
    again = gl.griffin_lim_staged_kernel(ms, 256, 8, momentum)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    want = gl.griffin_lim_staged_plain(ms, 256, 8, torch.bfloat16, momentum)
    assert got.shape == want.shape == (B, 256 * (T - 1))
    assert torch.equal(got, again)

    def peak_rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    if not momentum:
        assert peak_rel(got, want) <= 2e-2
        return
    g = torch.Generator(dev).manual_seed(T)
    probes = {"card": want, "cpu": gl.griffin_lim_staged_plain(
        ms.cpu(), 256, 8, torch.bfloat16, momentum).to(dev)}
    for i in range(GL_PROBES):
        moved = mag * (1.0 + 1e-6 * torch.randn(mag.shape, generator=g, device=dev))
        probes[f"nudged {i}"] = gl.griffin_lim_staged_plain(
            gl.staged_magnitudes(moved, torch.bfloat16), 256, 8, torch.bfloat16, momentum)
    readings = {k: peak_rel(got, p) for k, p in probes.items()}
    spread = [peak_rel(p, want) for k, p in probes.items() if k != "card"]
    limit = max(2e-2, GL_PROBE_MULTIPLE * float(np.median(spread)))
    rel4 = peak_rel(gl.griffin_lim_staged_kernel(ms, 256, 4, momentum),
                    gl.griffin_lim_staged_plain(ms, 256, 4, torch.bfloat16, momentum))
    l2 = (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()
    print(f"staged momentum B {B} T {T}: kernel vs plain at 8 iterations {readings['card']:.4g} "
          f"of the peak, vs the CPU plain {readings['cpu']:.4g}, nearest "
          f"{min(readings.values()):.4g}; CPU / nudged plain vs card plain: max "
          f"{max(spread):.4g}, median {float(np.median(spread)):.4g}; limit {limit:.4g}; "
          f"4 iterations {rel4:.4g}; relative L2 {l2:.4g}")
    assert min(readings.values()) <= limit, readings
    assert rel4 <= 2e-2
    assert l2 <= 2e-2


@pytest.mark.parametrize("hop", [128, 512])
def test_griffin_lim_staged_kernel_other_hops(dev, hop):
    """The hop template's other instances (n_fft / hop = 8 and 2)."""
    from multi_speaker_tts_tpu_torch.ops import griffin_lim_staged as gl

    rng = np.random.default_rng(hop)
    mag = torch.from_numpy(rng.random((2, 40, 513)).astype(np.float32) ** 2).to(dev)
    ms = gl.staged_magnitudes(mag, torch.bfloat16)
    got = gl.griffin_lim_staged_kernel(ms, hop, 8)
    want = gl.griffin_lim_staged_plain(ms, hop, 8, torch.bfloat16)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 2e-2


def test_bigru_and_staged_kernels_raise_on_shapes_they_refuse(dev):
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel
    from multi_speaker_tts_tpu_torch.ops import griffin_lim_staged as gl
    from multi_speaker_tts_tpu_torch.ops.gru import GRUParams

    counts = (birnn_kernel.GRU_KERNEL.launches, gl.KERNEL.launches)
    for H in (8, 72, 200):
        p = GRUParams(*(torch.zeros(s, device=dev) for s in ((16, 3 * H), (H, 3 * H),
                                                             (3 * H,), (3 * H,))))
        g = torch.zeros(5, 2, 3 * H, dtype=torch.bfloat16, device=dev)
        with pytest.raises(ValueError, match="H % 16"):
            birnn_kernel.bigru_recurrence_kernel(g, g, p, p)
    ms = torch.zeros(2, 20, 640, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="hop in"):
        gl.griffin_lim_staged_kernel(ms, 384, 2)
    with pytest.raises(ValueError, match="staged magnitudes"):
        gl.griffin_lim_staged_kernel(ms[:, :1].contiguous(), 256, 2)
    assert (birnn_kernel.GRU_KERNEL.launches, gl.KERNEL.launches) == counts


def test_bigru_bwd_and_mel_kernels_raise_on_shapes_they_refuse(dev):
    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel, mel_kernel

    counts = (birnn_kernel.GRU_BWD_KERNEL.launches, mel_kernel.KERNEL.launches,
              mel_kernel.DFT_KERNEL.launches)
    for H in (8, 72, 200):
        g, hp = (torch.zeros(5, 2, n, dtype=torch.bfloat16, device=dev) for n in (3 * H, H))
        w, dy = torch.zeros(H, 3 * H, device=dev), torch.zeros(5, 2, H, device=dev)
        with pytest.raises(ValueError, match="H % 16"):
            birnn_kernel.bigru_bwd_kernel(g, g, hp, g, g, hp, w, w, dy, dy)
    for n_fft, hop in ((1024, 300), (8192, 3000)):
        cfg = dsp.DSPConfig(22050, n_fft, hop, 80, 0.0, None, 0.97, -100.0, 20.0, 1.5, 60)
        with pytest.raises(ValueError, match="mel kernel needs"):
            mel_kernel.melspectrogram_kernel(torch.zeros(1, 4 * n_fft, device=dev), 2, cfg)
    assert (birnn_kernel.GRU_BWD_KERNEL.launches, mel_kernel.KERNEL.launches,
            mel_kernel.DFT_KERNEL.launches) == counts


def _decoder(rng, dev, H, D, P, A, mel, r, conv_k=31, conv_c=32, scale=0.02):
    # Weights at a trained model's scale: with larger random weights the AR
    # feedback is chaotic and amplifies f32 summation-order noise a million-fold
    # within ten steps (measured), which says nothing about the kernel.
    from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan

    def w(*shape, s=scale):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32)).to(dev)

    p = dscan.DecoderParams(
        lstm=(LSTMParams(w(P + D, 4 * H), w(H, 4 * H), w(4 * H)),
              LSTMParams(w(H + D, 4 * H), w(H, 4 * H), w(4 * H))),
        attention=dscan.AttentionParams(w(H, A), w(conv_k, 2, conv_c, s=0.3),
                                        w(conv_c, A, s=0.3), w(A, 1, s=0.3)),
        frame_proj=(w(H + D, mel * r), w(mel * r)),
        stop_proj=(w(H + D, 1), w(1)),
    )
    prenet = [(w(mel, P, s=0.2), w(P)), (w(P, P, s=0.2), w(P))]
    return p, prenet


# B, S, A, D, H, P, mel, r, K: the production widths; a small decoder; the
# edges of the redesign: one batch row, B 8 at K 16 (one full n-tile of the
# gate products, eight attention groups of eight blocks), the longest memory
# (S 256) with the widest attention (A 512) at the small demo checkpoint's
# width (H 256, D 256), B 16 (two n-tiles), and B 17, 32 and 40 at the
# production widths: row groups of at most 16, one launch each (17 and 40 with
# a short last group; 32 is what the daemon's max_batch pads 17-32 texts to).
DECODE_SHAPES = {
    "full": (4, 48, 128, 768, 1024, 256, 80, 2, 10),
    "small": (3, 24, 64, 128, 128, 128, 16, 2, 8),
    "b1": (1, 48, 128, 768, 1024, 256, 80, 2, 10),
    "b8_k16": (8, 48, 128, 768, 1024, 256, 80, 2, 16),
    "s256_a512_w256": (2, 256, 512, 256, 256, 128, 80, 2, 6),
    "b16": (16, 32, 128, 256, 256, 128, 80, 2, 4),
    "b17": (17, 48, 128, 768, 1024, 256, 80, 2, 10),
    "b32": (32, 48, 128, 768, 1024, 256, 80, 2, 10),
    "b40": (40, 48, 128, 768, 1024, 256, 80, 2, 10),
    # Past the JAX package's 256 positions, at row counts whose launch the
    # card's shared memory splits into groups (kernel_row_groups).
    "s272_b16": (16, 272, 128, 768, 1024, 256, 80, 2, 10),
    "s272_b1": (1, 272, 128, 768, 1024, 256, 80, 2, 10),
    "s1024_b16": (16, 1024, 128, 768, 1024, 256, 80, 2, 10),
    "s1024_b1": (1, 1024, 128, 768, 1024, 256, 80, 2, 10),
}


@pytest.mark.parametrize("quantize", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("shape", list(DECODE_SHAPES))
def test_decode_segment_kernel(dev, quantize, shape, monkeypatch):
    from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk
    from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan

    B, S, A, D, H, P, mel, r, K = DECODE_SHAPES[shape]
    rng = np.random.default_rng(5)
    p, prenet = _decoder(rng, dev, H, D, P, A, mel, r)
    bundle = dk.prepare_bundle(p, prenet, quantize=quantize)
    assert dk.prepare_bundle(p, prenet, quantize=quantize) is bundle  # packed once
    t = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.3).astype(np.float32)).to(dev)  # noqa: E731
    keys, memory = t(B, S, A), t(B, S, D)
    lens = torch.tensor(([S, S - 5, 7, S] * 16)[:B], device=dev)
    mask = (torch.arange(S, device=dev)[None] < lens[:, None]).float()
    keep = [torch.from_numpy(rng.random((K, B, P)) < 0.5).to(dev).float() / 0.5 for _ in range(2)]
    carry = dscan.initial_carry(B, memory, 2, H)
    prev = torch.zeros(B, mel, device=dev)
    kernel = dk.KERNELS["int8" if quantize else "bf16"]
    for _ in range(2):  # from the zero state, then from the kernel's own carry
        before = kernel.launches
        got = dk.decode_segment(bundle, keys, memory, mask, carry, prev, *keep, K, mel, r)
        again = dk.decode_segment(bundle, keys, memory, mask, carry, prev, *keep, K, mel, r)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2 * len(dk.kernel_row_groups(bundle, B, S, dev))
        # The query's sums are exact (64-bit fixed point), every other sum in
        # a fixed order: the same inputs give the same outputs, bit for bit.
        assert all(torch.equal(x, y) for x, y in zip(got[1:], again[1:]))
        assert all(torch.equal(x, y) for x, y in zip((*got[0].h, *got[0].c, got[0].context),
                                                     (*again[0].h, *again[0].c, again[0].context)))
        want = dk.decode_segment_plain(bundle, keys, memory, mask, carry, prev, *keep, K, mel, r)
        # f32 sums in another order flip a few int8 / bf16 operand roundings,
        # which the feedback compounds over K steps (frames and stops 1e-2,
        # aligns 1e-3: the decode_pallas_int8_vs_xla_int8 gate).
        assert (got[2] - want[2]).abs().max().item() <= 1e-2
        assert (got[3] - want[3]).abs().max().item() <= 1e-2
        assert (got[4] - want[4]).abs().max().item() <= 1e-3
        assert (got[1] - want[1]).abs().max().item() <= 1e-2
        for a, b in zip((*got[0].h, *got[0].c, got[0].weights, got[0].cum_weights,
                         got[0].context),
                        (*want[0].h, *want[0].c, want[0].weights, want[0].cum_weights,
                         want[0].context)):
            assert a.shape == b.shape and (a - b).abs().max().item() <= 1e-2
        carry, prev = got[0], got[1]

    # On the card the dispatcher never takes the plain version.
    def boom(*a, **k):
        raise AssertionError("plain decode ran on a CUDA tensor")

    monkeypatch.setattr(dk, "decode_segment_plain", boom)
    dk.decode_segment(bundle, keys, memory, mask, carry, prev, None, None, K, mel, r)
    torch.cuda.synchronize()


@pytest.mark.parametrize("quantize", [True, False], ids=["int8", "bf16"])
def test_decode_segment_kernel_rows_are_independent(dev, quantize):
    """What the early-exit loop's compaction to the rows still decoding
    relies on: a row's outputs do not depend on the rows that share its
    launch or on its place in it. 16 rows at the production widths in one
    launch, against rows 9-15 and then rows 0-8 launched apart: bit-equal
    row by row, from the zero state and from the kernel's own carry."""
    from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk
    from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan

    B, S, A, D, H, P, mel, r, K = 16, 48, 128, 768, 1024, 256, 80, 2, 10
    rng = np.random.default_rng(8)
    p, prenet = _decoder(rng, dev, H, D, P, A, mel, r)
    bundle = dk.prepare_bundle(p, prenet, quantize=quantize)
    assert len(dk.kernel_row_groups(bundle, B, S, dev)) == 1
    t = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.3).astype(np.float32)).to(dev)  # noqa: E731
    keys, memory = t(B, S, A), t(B, S, D)
    lens = torch.tensor(([S, S - 5, 7, S] * 4), device=dev)
    mask = (torch.arange(S, device=dev)[None] < lens[:, None]).float()
    keep = [torch.from_numpy(rng.random((K, B, P)) < 0.5).to(dev).float() / 0.5 for _ in range(2)]
    carry = dscan.initial_carry(B, memory, 2, H)
    prev = torch.zeros(B, mel, device=dev)

    def flat(out):  # every output with its rows on dim 0
        carry_, prev_, f, s_, w = out
        return [*carry_.h, *carry_.c, carry_.weights, carry_.cum_weights, carry_.context, prev_,
                f.transpose(0, 1), s_.transpose(0, 1), w.transpose(0, 1)]

    for _ in range(2):
        whole = dk.decode_segment_kernel(bundle, keys, memory, mask, carry, prev, *keep, K, mel, r)
        for rows in (torch.arange(9, 16, device=dev), torch.arange(0, 9, device=dev)):
            part = dk.decode_segment_kernel(
                bundle, keys[rows], memory[rows], mask[rows], dscan.take_rows(carry, rows),
                prev[rows], *(m[:, rows] for m in keep), K, mel, r)
            gaps = [(a[rows] - b).abs().max().item() for a, b in zip(flat(whole), flat(part))]
            assert max(gaps) == 0.0, gaps
        carry, prev = whole[0], whole[1]


def test_decode_kernel_raises_on_unsupported_shapes(dev):
    from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk
    from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan

    rng = np.random.default_rng(6)
    p, prenet = _decoder(rng, dev, 128, 136, 128, 64, 16, 2)  # memory width off the grid
    bundle = dk.prepare_bundle(p, prenet)
    memory = torch.zeros(2, 24, 136, device=dev)
    with pytest.raises(ValueError, match="multiples of 16"):
        dk.decode_segment(bundle, torch.zeros(2, 24, 64, device=dev), memory,
                          torch.ones(2, 24, device=dev), dscan.initial_carry(2, memory, 2, 128),
                          torch.zeros(2, 16, device=dev), None, None, 4, 16, 2)
    # In bf16, more units a block than its four m-tiles of gate rows hold
    # (int8 takes them in passes).
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    H = 16 * (-(-(dk.MAX_UNITS * (n_sm - dk.PRENET_BLOCKS) + 1) // 16))
    p, prenet = _decoder(rng, dev, H, 128, 128, 64, 16, 2)
    bundle = dk.prepare_bundle(p, prenet, quantize=False)
    memory = torch.zeros(2, 24, 128, device=dev)
    with pytest.raises(ValueError, match="gate rows a block"):
        dk.decode_segment(bundle, torch.zeros(2, 24, 64, device=dev), memory,
                          torch.ones(2, 24, device=dev), dscan.initial_carry(2, memory, 2, H),
                          torch.zeros(2, 16, device=dev), None, None, 4, 16, 2)


@pytest.mark.parametrize("H", [128, 256, 1024, 1152, 2048, 3072, 8192])
def test_decode_kernel_layout_is_the_mirrored_one(dev, H):
    """The grid the kernel computes on this card is decode_layout's."""
    import ctypes

    from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    dims = (ctypes.c_int * 13)(10, 4, 48, 128, 768, H, 256, 256, 80, 2, 31, 32, 1)
    out = (ctypes.c_int * 10)()
    assert dk.KERNELS["int8"].lib().mstts_decode_layout(dims, ctypes.addressof(out)) == 0
    want = dk.decode_layout(H, n_sm)
    assert list(out)[:3] == [want["U"], want["nblk"], want["grid"]] and out[4] == want["mt"]


# Widths (H, D, P1, P2, A, mel, conv_k, conv_c) of the layout grid: the
# production decoder, the small demo checkpoint's, and a wide attention.
LAYOUT_WIDTHS = [(1024, 768, 256, 256, 128, 80, 31, 32), (256, 320, 64, 64, 64, 80, 31, 32),
                 (256, 256, 128, 128, 512, 80, 31, 32), (512, 512, 256, 256, 128, 80, 15, 16),
                 # past H 1024: the weights partly streamed, up to four m-tiles
                 (1152, 512, 256, 256, 128, 80, 31, 32), (1536, 512, 256, 256, 640, 80, 31, 32),
                 (2048, 512, 256, 256, 1024, 80, 31, 32),
                 # int8 past H 2048: passes of four m-tiles, wq out of shared memory
                 (2176, 512, 256, 256, 128, 80, 31, 32), (4096, 512, 256, 256, 1024, 80, 31, 32)]


@pytest.mark.parametrize("widths", LAYOUT_WIDTHS, ids=lambda w: f"H{w[0]}_D{w[1]}_A{w[4]}")
def test_decode_layout_bytes_is_the_kernels(dev, widths):
    """``layout_bytes`` (the Python copy of make_layout and of the fit test)
    against ``mstts_decode_layout`` on this card: the bytes and the fit of
    every row count 1-16 at S 16-6000, both modes."""
    import ctypes

    from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk

    w = dk.Widths(*widths)
    card = dk.card_limits(dev)
    lib = dk.KERNELS["int8"].lib()
    out = (ctypes.c_int * 10)()
    for q in (0, 1):
        for B in range(1, 17):
            for S in list(range(16, 6001, 48)) + [1, 2, 255, 257]:
                dims = (ctypes.c_int * 13)(10, B, S, w.A, w.D, w.H, w.P1, w.P2, w.mel, 2,
                                           w.conv_k, w.conv_c, q)
                assert lib.mstts_decode_layout(dims, ctypes.addressof(out)) == 0
                got = dk.layout_bytes(B, S, w, bool(q), *card)
                assert ((got["total"], got["fits"], got["r0"], got["r1"])
                        == (out[6], bool(out[7]), out[8], out[9])), (q, B, S)


LONG = ("the quick brown fox jumps over the lazy dog. she sells sea shells by the sea "
        "shore. a stitch in time saves nine. all that glitters is not gold. pack my box "
        "with five dozen liquor jugs now.")


@pytest.mark.parametrize("quantize", ["int8_pallas", "bf16_pallas"])
def test_sixteen_texts_with_a_long_one_on_the_card(dev, quantize, monkeypatch):
    """16 texts, the longest 200 characters (S 208): in bf16 16 rows do not
    fit one launch there, so the kernel runs the row groups the layout
    sizes; no plain decode step; the same request twice, the same lengths."""
    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk
    from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan

    texts = [(LONG + " " + LONG)[:206]] + ["hello world.", "she sells sea shells.", "a b c"] * 5
    synth = Synthesizer.from_compact(str(ROOT / "demo" / "serving_ckpt_full.msgpack"),
                                     quantize=quantize)

    def boom(*a, **k):
        raise AssertionError("the plain decode ran under a kernel mode")

    monkeypatch.setattr(dscan, "decoder_cell_step", boom)
    monkeypatch.setattr(dk, "decode_segment_plain", boom)
    chunks = []
    real = dk.decode_segment_kernel
    monkeypatch.setattr(dk, "decode_segment_kernel",
                        lambda b, keys, *a: chunks.append(keys.shape) or real(b, keys, *a))
    kernel = dk.KERNELS[quantize.split("_")[0]]
    emb = synth.enroll([str(ROOT / "demo" / "enroll_spk0_utt0.wav")])
    before = kernel.launches
    out = synth.synthesize(texts, emb, vocode=False)
    # The first chunk runs every row; later ones the rows still decoding.
    assert chunks and chunks[0][:2] == (16, 208) and all(c[1] == 208 for c in chunks)
    assert all(a[0] >= b[0] for a, b in zip(chunks, chunks[1:]))
    bundle = dk.prepare_bundle(synth.tacotron.decoder.params(),
                               [(d.kernel, d.bias) for d in synth.tacotron.decoder.prenet],
                               quantize=quantize == "int8_pallas")
    groups = dk.kernel_row_groups(bundle, 16, 208, dev)
    assert len(groups) == (1 if quantize == "int8_pallas" else 2)
    assert kernel.launches - before == sum(len(dk.kernel_row_groups(bundle, c[0], 208, dev))
                                           for c in chunks)
    assert all(np.isfinite(o["mel"]).all() and o["mel_length"] > 0 for o in out)
    again = synth.synthesize(texts, emb, vocode=False)
    assert [o["mel_length"] for o in again] == [o["mel_length"] for o in out]


def test_decode_past_the_kernels_limit_on_the_card(dev, capsys):
    """A text past the bf16 kernel's one-row limit: the AR decode runs the
    plain loop on the card with one dispatch line and launches no decode
    kernel; a direct call of the kernel there raises."""
    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk
    from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan

    synth = Synthesizer.from_compact(str(ROOT / "demo" / "serving_ckpt_full.msgpack"),
                                     quantize="bf16_pallas")
    dec = synth.tacotron.decoder
    bundle = dk.prepare_bundle(dec.params(), [(d.kernel, d.bias) for d in dec.prenet],
                               quantize=False)
    limit = dk.max_positions(dk.widths_of(bundle), False, *dk.card_limits(dev))
    text = (LONG + " ") * (limit // len(LONG) + 1)
    text = text[:limit + 4]
    emb = synth.enroll([str(ROOT / "demo" / "enroll_spk0_utt0.wav")])
    dsp._DISPATCH_LOGGED.discard(("decode", "plain"))
    before = {m: k.launches for m, k in dk.KERNELS.items()}
    out = synth.synthesize([text], emb, vocode=False, max_steps=64)
    assert {m: k.launches for m, k in dk.KERNELS.items()} == before
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("[dispatch] decode")]
    assert len(lines) == 1 and "-> plain" in lines[0] and str(limit) in lines[0], lines
    assert np.isfinite(out[0]["mel"]).all() and out[0]["mel_length"] > 0
    S = -(-(limit + 1) // 16) * 16
    memory = torch.zeros(1, S, 768, device=dev)
    with pytest.raises(ValueError, match=f"at most {limit} memory positions"):
        dk.decode_segment_kernel(bundle, torch.zeros(1, S, 128, device=dev), memory,
                                 torch.ones(1, S, device=dev),
                                 dscan.initial_carry(1, memory, 2, 1024),
                                 torch.zeros(1, 80, device=dev), None, None, 4, 80, 2)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("quantize", [None, "int8_pallas", "bf16_pallas"])
def test_full_checkpoint_as_it_is_on_the_card(dev, quantize, early_exit, monkeypatch):
    """The shipped checkpoint with its CBHG head; under ``*_pallas`` the
    plain decode step never runs, in the early-exit loop or in the
    fixed-length decode."""
    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel, decode_kernel as dk
    from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan

    synth = Synthesizer.from_compact(str(ROOT / "demo" / "serving_ckpt_full.msgpack"),
                                     quantize=quantize)
    if quantize is not None:
        def boom(*a, **k):
            raise AssertionError("the plain decode ran under a kernel mode")

        monkeypatch.setattr(dscan, "decoder_cell_step", boom)
        monkeypatch.setattr(dk, "decode_segment_plain", boom)
    emb = synth.enroll([str(ROOT / "demo" / "enroll_spk0_utt0.wav")])
    before = birnn_kernel.GRU_KERNEL.launches
    launched = {m: k.launches for m, k in dk.KERNELS.items()}
    out = synth.synthesize(["hello world.", "a b c"], emb, pcm16=True, early_exit=early_exit)
    assert birnn_kernel.GRU_KERNEL.launches == before + 1
    for mode, kernel in dk.KERNELS.items():
        assert (kernel.launches > launched[mode]) == (quantize == f"{mode}_pallas")
    for item in out:
        assert item["wav"].dtype == np.int16 and item["mel_length"] > 0
        assert item["linear"].shape == (item["mel_length"], 513)
        assert np.isfinite(item["linear"]).all()


def test_synthesizer_on_the_card(dev):
    from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
    from multi_speaker_tts_tpu_torch.checkpoints import load_compact
    from multi_speaker_tts_tpu_torch.inference import Synthesizer

    params, batch_stats, meta = load_compact(ROOT / "demo" / "serving_ckpt.msgpack")
    hp = Recursive_Parse(meta["hp"]).replace(Linear_Head={"Use": False})
    synth = Synthesizer(hp, params, batch_stats)
    assert synth.device.type == "cuda"
    emb = synth.enroll([str(ROOT / "demo" / "enroll_spk0_utt0.wav")])
    out = synth.synthesize(["hello world.", "a b c"], emb, pcm16=True)
    for item in out:
        assert item["wav"].dtype == np.int16 and item["mel_length"] > 0
        assert np.isfinite(item["mel"]).all()


@pytest.mark.parametrize("quantize", [None, "int8_pallas"])
def test_stream_on_the_card(dev, quantize):
    """The small checkpoint with its Conv head, streamed: windows vocoded by
    the staged kernel at T = G + E + Gr, the mel blocks equal to the
    batched mel under the same dropout draws."""
    from multi_speaker_tts_tpu_torch.checkpoints import load_compact
    from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.ops import decode_kernel
    from multi_speaker_tts_tpu_torch.ops import griffin_lim_staged as gl

    params, batch_stats, meta = load_compact(ROOT / "demo" / "serving_ckpt.msgpack")
    synth = Synthesizer(Recursive_Parse(meta["hp"]), params, batch_stats, quantize=quantize)
    emb = synth.enroll([str(ROOT / "demo" / "enroll_spk0_utt0.wav")])
    texts = ["hello world.", "a b c"]
    before = (gl.KERNEL.launches, decode_kernel.KERNELS["int8"].launches)
    chunks = list(synth.stream(texts, emb, segment_steps=16, pcm16=True, return_mel=True))
    assert gl.KERNEL.launches - before[0] == len(chunks)
    if quantize:
        assert decode_kernel.KERNELS["int8"].launches > before[1]
    out = synth.synthesize(texts, emb)
    mel = np.concatenate([c["mel_chunk"] for c in chunks], axis=1)
    for b, item in enumerate(out):
        T = item["mel_length"]
        assert chunks[-1]["mel_lengths"][b] == T
        assert np.abs(mel[b, :T] - item["mel"]).max() <= 1e-4
    for c in chunks:
        assert c["wav_chunk"].dtype == np.int16 and c["wav_chunk"].shape[1] == 32 * 256


def _rel_peak(got, want) -> float:
    """max |got - want| over max |want|."""
    err = (got.float() - want.float()).abs().max()
    return (err / want.float().abs().max().clamp(min=1e-9)).item()


@pytest.mark.parametrize("B, D, H, T", [(32, 80, 768, 24), (32, 768, 768, 24), (5, 128, 128, 24),
                                        *LSTM_EDGES])
def test_lstm_residual_mode_and_backward_kernel(dev, B, D, H, T):
    from multi_speaker_tts_tpu_torch.ops import lstm_kernel

    rng = np.random.default_rng(B + D)
    p = _lstm(rng, D, H, dev)
    x = torch.from_numpy(rng.normal(size=(T, B, D)).astype(np.float32)).to(dev, torch.bfloat16)
    got = lstm_kernel.lstm_seq_layer_kernel(p, x, save_residuals=True)
    want = lstm_kernel.lstm_seq_layer_plain(p, x, torch.bfloat16, save_residuals=True)
    # The residual mode changes no output of the inference mode.
    assert torch.equal(got[0], lstm_kernel.lstm_seq_layer_kernel(p, x)[0])
    for a, b in zip(got, want):  # ys, h_T, c_T, gates, c_prev
        assert a.shape == b.shape and _rel_peak(a, b) <= 1e-2
    gates, c_prev = got[3], got[4]
    d_hT = torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32)).to(dev)
    d_ys = torch.from_numpy(rng.normal(size=(T, B, H)).astype(np.float32)).to(dev)
    for dh, dys in ((d_hT, None), (None, d_ys), (d_hT, d_ys)):
        before = lstm_kernel.BWD_KERNEL.launches
        dG = lstm_kernel.lstm_seq_layer_bwd(p.w_hh, gates, c_prev, dh, dys)
        torch.cuda.synchronize()
        assert lstm_kernel.BWD_KERNEL.launches == before + 1
        ref = lstm_kernel.lstm_seq_layer_bwd_plain(p.w_hh, gates, c_prev, dh, dys)
        # bf16 dG from the same residuals; f32 sums in another order.
        assert dG.dtype == torch.bfloat16 and _rel_peak(dG, ref) <= 1e-2


@pytest.mark.parametrize("B, S, H", [(32, 64, 256), *BILSTM_EDGES])
def test_bilstm_residual_mode_and_backward_kernel(dev, B, S, H):
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel

    rng = np.random.default_rng(3)
    pf, pb = _lstm(rng, 512, H, dev), _lstm(rng, 512, H, dev)
    x = torch.from_numpy(rng.normal(size=(B, S, 512)).astype(np.float32)).to(dev)
    gxf, gxb = birnn_kernel.bilstm_hoist(pf, pb, x, torch.bfloat16)
    got = birnn_kernel.bilstm_recurrence_kernel(gxf, gxb, pf.w_hh, pb.w_hh, save_residuals=True)
    want = birnn_kernel.bilstm_recurrence_plain(gxf, gxb, pf.w_hh, pb.w_hh, torch.bfloat16,
                                                save_residuals=True)
    for a, b in zip(got, want):  # ysf, ysb, gf, cf, gb, cb
        assert a.shape == b.shape and _rel_peak(a, b) <= 1e-2
    dyf, dyb = (torch.from_numpy(rng.normal(size=(S, B, H)).astype(np.float32)).to(dev)
                for _ in range(2))
    args = (*got[2:], pf.w_hh, pb.w_hh, dyf, dyb)
    before = birnn_kernel.BWD_KERNEL.launches
    dG = birnn_kernel.bilstm_bwd(*args)
    torch.cuda.synchronize()
    assert birnn_kernel.BWD_KERNEL.launches == before + 1
    for a, b in zip(dG, birnn_kernel.bilstm_bwd_plain(*args)):
        assert _rel_peak(a, b) <= 1e-2


@pytest.mark.parametrize("threads", [256, 512])
def test_barrier_floor_kernel_at_a_block_size(dev, threads):
    """The floor of the decode segment's grid (512-thread blocks, one an
    SM) and of the dense Griffin-Lim's (256): one arrival a block a round."""
    from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk
    from multi_speaker_tts_tpu_torch.ops import recurrence_floor

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = dk.decode_layout(1024, sms)["grid"]
    blocks, bar = recurrence_floor.barrier_floor(49, 1, 1, dev, blocks=want, threads=threads)
    torch.cuda.synchronize()
    assert blocks == want <= sms
    assert bar.item() == 49 * blocks


@pytest.mark.parametrize("ndir, H", [(1, 768), (2, 256), ("gl", 128)])
def test_barrier_floor_kernel(dev, ndir, H):
    """The floor kernel runs its rounds on the recurrences' grid, or on the
    staged Griffin-Lim's (an explicit block count; T = H frames, B = 4,
    hop 256): one arrival per block per round."""
    from multi_speaker_tts_tpu_torch.ops import griffin_lim_staged as gl
    from multi_speaker_tts_tpu_torch.ops import recurrence_floor

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    before = recurrence_floor.KERNEL.launches
    if ndir == "gl":
        want = gl.kernel_blocks(4, H, 256)
        assert want == 4 * min(4 * -(-H // 16), sms // 4)
        blocks, bar = recurrence_floor.barrier_floor(64, 1, 1, dev, blocks=want)
        assert blocks == want
    else:
        blocks, bar = recurrence_floor.barrier_floor(64, ndir, H, dev)
        U = -(-ndir * H // sms)
        assert blocks == ndir * -(-H // U)
    torch.cuda.synchronize()
    assert blocks <= sms
    assert bar.item() == 64 * blocks
    assert recurrence_floor.KERNEL.launches == before + 1


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("B, H", [(4, 128), (32, 128), (17, 192)])
def test_gru_chain_floor_kernel(dev, B, H, backward):
    """The BiGRU's sequential floors (forward and backward) run on the
    BiGRU's grid, one launch a call."""
    from multi_speaker_tts_tpu_torch.ops import recurrence_floor

    before = recurrence_floor.KERNEL.launches
    blocks = recurrence_floor.gru_chain_floor(50, B, H, dev, backward)
    torch.cuda.synchronize()
    assert blocks == 2 * -(-B // 8)
    assert recurrence_floor.KERNEL.launches == before + 1


def test_bigru_residual_mode_and_backward_kernel(dev):
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel
    from multi_speaker_tts_tpu_torch.ops.gru import GRUParams

    rng = np.random.default_rng(4)

    def gru(D, H):
        return GRUParams(*(torch.from_numpy((rng.normal(size=s) * 0.1).astype(np.float32)).to(dev)
                           for s in ((D, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))))

    for B, T, H in ((32, 132, 128), (3, 24, 64)):
        pf, pb = gru(128, H), gru(128, H)
        x = torch.from_numpy(rng.normal(size=(B, T, 128)).astype(np.float32)).to(dev)
        gxf, gxb = birnn_kernel.bigru_hoist(pf, pb, x, torch.bfloat16)
        got = birnn_kernel.bigru_recurrence_kernel(gxf, gxb, pf, pb, save_residuals=True)
        want = birnn_kernel.bigru_recurrence_plain(gxf, gxb, pf, pb, torch.bfloat16,
                                                   save_residuals=True)
        assert torch.equal(got[0], birnn_kernel.bigru_recurrence_kernel(gxf, gxb, pf, pb)[0])
        for a, b in zip(got, want):  # ysf, ysb, ghf, hpf, ghb, hpb
            assert a.shape == b.shape and _rel_peak(a, b) <= 1e-2
        dyf, dyb = (torch.from_numpy(rng.normal(size=(T, B, H)).astype(np.float32)).to(dev)
                    for _ in range(2))
        ysf, ysb, ghf, hpf, ghb, hpb = got
        args = (gxf, ghf, hpf, gxb, ghb, hpb, pf.w_hh, pb.w_hh, dyf, dyb)
        before = birnn_kernel.GRU_BWD_KERNEL.launches
        dG = birnn_kernel.bigru_bwd(*args)
        torch.cuda.synchronize()
        assert birnn_kernel.GRU_BWD_KERNEL.launches == before + 1
        for a, b in zip(dG, birnn_kernel.bigru_bwd_plain(*args)):  # dGx, dGh per direction
            assert _rel_peak(a, b) <= 1e-2


def _train_batch(hp, B, seed=0):
    from multi_speaker_tts_tpu_torch.data.collate import collate_tts
    from multi_speaker_tts_tpu_torch.text import vocab_size

    rng = np.random.default_rng(seed)
    M, F = hp.Sound.Mel_Dim, hp.Sound.Spectrogram_Dim
    pats = [{"Tokens": rng.integers(1, vocab_size(hp), size=40 - i),
             "Mel": rng.random((120 - 4 * i, M)), "Spect": rng.random((120 - 4 * i, F))}
            for i in range(B)]
    return collate_tts(pats, 64, 132, M, hp.Decoder.N_Frames_Per_Step,
                       hp.Speaker_Embedding.GE2E.Window_Length, rng, F)


def test_train_step_full_width_on_the_card(dev, monkeypatch):
    """The full checkpoint with GE2E trainable: one step launches each
    backward kernel (the LSTM's once a layer) and the residual modes, runs
    no plain backward, stays finite and moves the weights; an f32
    checkpoint trains by the reference's routing: no recurrence kernel,
    forward or backward, launches, and its step is finite."""
    from multi_speaker_tts_tpu_torch.checkpoints import load_compact
    from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel, lstm_kernel
    from multi_speaker_tts_tpu_torch.train.trainer import Trainer

    params, batch_stats, meta = load_compact(ROOT / "demo" / "serving_ckpt_full.msgpack")
    # No warmup, so the first step's learning rate (1e-3) moves every
    # recurrent tensor by more than an f32 ulp.
    hp = Recursive_Parse(meta["hp"]).replace(Speaker_Embedding={"GE2E": {"Freeze": False}},
                                             Train={"Learning_Rate": {"Warmup_Step": 1}})
    trainer = Trainer.from_params(hp, params, batch_stats)
    batch = _train_batch(hp, 4)

    def boom(*a, **k):
        raise AssertionError("a plain backward ran on the card")

    for mod, name in ((lstm_kernel, "lstm_seq_layer_bwd_plain"),
                      (birnn_kernel, "bilstm_bwd_plain"), (birnn_kernel, "bigru_bwd_plain")):
        monkeypatch.setattr(mod, name, boom)
    kernels = {"lstm_bwd": lstm_kernel.BWD_KERNEL, "lstm_res": lstm_kernel.RES_KERNEL,
               "bilstm_bwd": birnn_kernel.BWD_KERNEL, "bilstm_res": birnn_kernel.RES_KERNEL,
               "bigru_bwd": birnn_kernel.GRU_BWD_KERNEL, "bigru_res": birnn_kernel.GRU_RES_KERNEL}
    before = {k: v.launches for k, v in kernels.items()}
    w0 = [p.detach().clone() for p in trainer.params]
    metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    launched = {k: v.launches - before[k] for k, v in kernels.items()}
    assert launched == {"lstm_bwd": 3, "lstm_res": 3, "bilstm_bwd": 1, "bilstm_res": 1,
                        "bigru_bwd": 1, "bigru_res": 1}
    assert metrics["skipped_nonfinite"] == 0.0
    assert all(np.isfinite(v) for v in metrics.values())
    still = [n for n, a, p in zip(trainer.param_names, w0, trainer.params)
             if ("lstm" in n or "gru" in n) and torch.equal(a, p.detach())]
    assert not still, still

    f32 = hp.replace(Train={"Use_Mixed_Precision": False})
    for kern in (lstm_kernel.KERNEL, birnn_kernel.KERNEL, birnn_kernel.GRU_KERNEL):
        kernels[kern.name] = kern
    before = {k: v.launches for k, v in kernels.items()}
    metrics = Trainer.from_params(f32, params, batch_stats).train_step(batch)
    torch.cuda.synchronize()
    assert {k: v.launches - before[k] for k, v in kernels.items()} == dict.fromkeys(kernels, 0)
    assert metrics["skipped_nonfinite"] == 0.0
    assert all(np.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decoder_tf_scan_function_on_the_card(dev, cd):
    """The teacher-forced scan's Function against decoder_tf_scan_ref under
    autograd at the train step's shape (T 66, B 32, S 64, H 1024, memory
    768, prenet 256, attention 128, conv 31 x 32): every gradient within
    1e-3 of its peak in f32, 5e-2 in bf16 (bf16 residuals and dG against
    autograd's f32 intermediates); the forward outputs equal."""
    from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan

    rng = np.random.default_rng(11)
    T, B, S, P, Dm, H, A, K, C = 66, 32, 64, 256, 768, 1024, 128, 31, 32

    def leaf(*shape, scale=0.02):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(
            dev).requires_grad_()

    lstm = [LSTMParams(leaf(P + Dm, 4 * H), leaf(H, 4 * H), leaf(4 * H)),
            LSTMParams(leaf(H + Dm, 4 * H), leaf(H, 4 * H), leaf(4 * H))]
    att = dscan.AttentionParams(leaf(H, A, scale=0.1), leaf(K, 2, C, scale=0.3),
                                leaf(C, A, scale=0.3), leaf(A, 1, scale=0.3))
    pre, keys, mem = leaf(T, B, P, scale=1.0), leaf(B, S, A, scale=0.5), leaf(B, S, Dm, scale=0.5)
    lens = torch.tensor([S - (7 * b) % 40 for b in range(B)], device=dev)
    mask = (torch.arange(S, device=dev)[None] < lens[:, None]).float()
    p = dscan.DecoderParams(tuple(lstm), att, None, None)
    leaves = [w for q in lstm for w in q] + list(att) + [pre, keys, mem]
    gen = torch.Generator(dev).manual_seed(0)
    px = torch.randn((T, B, H + Dm), generator=gen, device=dev)
    pw = torch.randn((T, B, S), generator=gen, device=dev)
    outs, grads = [], []
    for fn in (dscan.decoder_tf_scan_ref, dscan.decoder_tf_scan):
        xs, ws = fn(p, pre, keys, mem, mask, cd)
        outs.append((xs.detach(), ws.detach()))
        grads.append(torch.autograd.grad((xs * px).sum() + (ws * pw).sum(), leaves))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    tol = 1e-3 if cd == torch.float32 else 5e-2
    for a, b in zip(*grads):
        assert float((a - b).abs().max() / a.abs().max()) <= tol


def _cli_corpus(tmp_path):
    from multi_speaker_tts_tpu_torch.data.pattern_generator import generate_synthetic_dataset
    from multi_speaker_tts_tpu_torch.hparams import default_hparams

    hp = default_hparams(Train={"Batch_Size": 8, "Num_Workers": 0},
                         GE2E_Train={"Batch_Speakers": 4, "Batch_Utterances": 4})
    generate_synthetic_dataset(hp, tmp_path / "corpus", n_speakers=4, n_utterances=2,
                               voice="rich")
    (tmp_path / "hp.json").write_text(__import__("json").dumps(hp.to_dict()))
    return ["-hp", str(tmp_path / "hp.json"), "-train_pattern",
            str(tmp_path / "corpus" / "patterns"), "-log", str(tmp_path / "logs")]


def test_train_cli_one_step_each_mode_on_the_card(dev, tmp_path, monkeypatch):
    """``train.__main__.main`` at the production widths (batch 8, GE2E 4 x
    4): one GE2E step (kernels #2r and #8 three times each), then one TTS
    step from that encoder (the three recurrences' residual and backward
    kernels), no plain backward; both checkpoints written."""
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel, lstm_kernel
    from multi_speaker_tts_tpu_torch.train import __main__ as cli
    from multi_speaker_tts_tpu_torch.train.checkpoints import CheckpointManager

    def boom(*a, **k):
        raise AssertionError("a plain backward ran on the card")

    for mod, name in ((lstm_kernel, "lstm_seq_layer_bwd_plain"),
                      (birnn_kernel, "bilstm_bwd_plain"), (birnn_kernel, "bigru_bwd_plain")):
        monkeypatch.setattr(mod, name, boom)
    common = _cli_corpus(tmp_path)
    kernels = {"lstm_bwd": lstm_kernel.BWD_KERNEL, "lstm_res": lstm_kernel.RES_KERNEL,
               "bilstm_bwd": birnn_kernel.BWD_KERNEL, "bilstm_res": birnn_kernel.RES_KERNEL,
               "bigru_bwd": birnn_kernel.GRU_BWD_KERNEL, "bigru_res": birnn_kernel.GRU_RES_KERNEL}
    before = {k: v.launches for k, v in kernels.items()}
    cli.main(common + ["-mode", "ge2e", "-checkpoint", str(tmp_path / "ge2e"), "-max_step", "1"])
    ge2e = {k: v.launches - before[k] for k, v in kernels.items()}
    assert ge2e == {"lstm_bwd": 3, "lstm_res": 3, "bilstm_bwd": 0, "bilstm_res": 0,
                    "bigru_bwd": 0, "bigru_res": 0}
    before = {k: v.launches for k, v in kernels.items()}
    cli.main(common + ["-mode", "tts", "-checkpoint", str(tmp_path / "tts"), "-ge2e_checkpoint",
                       str(tmp_path / "ge2e"), "-max_step", "1"])
    tts = {k: v.launches - before[k] for k, v in kernels.items()}
    assert tts == {"lstm_bwd": 3, "lstm_res": 3, "bilstm_bwd": 1, "bilstm_res": 1,
                   "bigru_bwd": 1, "bigru_res": 1}
    assert CheckpointManager(tmp_path / "ge2e").steps() == [1]
    state, step = CheckpointManager(tmp_path / "tts").restore()
    assert step == 1 and all(torch.isfinite(v).all() for v in state["params"].values())


def _attention_case(dev, B, S, A, D, H, C, seed, masked=False, scale=0.1):
    """Probe-style inputs for one fused attention step: normal x ``scale``
    weights and keys, previous weights a softmax, cumulative weights above
    them, padded with the location conv's zeros; ``masked`` zeroes the last
    third of every row."""
    from multi_speaker_tts_tpu_torch.ops import attention_step_kernel as ask
    from multi_speaker_tts_tpu_torch.ops.decoder_scan import AttentionParams

    rng = np.random.default_rng(seed)
    K = 31
    half = (K - 1) // 2

    def f(*shape):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    ap = AttentionParams(f(H, A), f(K, 2, C), f(C, A), f(A, 1))
    keys, memory, h0 = f(B, S, A), f(B, S, D), f(B, H)
    w = torch.softmax(torch.from_numpy(rng.normal(size=(B, S)).astype(np.float32)), -1).to(dev)
    cum = w + torch.from_numpy(rng.uniform(0, 2, (B, S)).astype(np.float32)).to(dev)
    mask = torch.ones(B, S, device=dev)
    if masked:
        mask[:, 2 * S // 3:] = 0.0
    pad = (half, K - 1 - half)
    return (h0, torch.nn.functional.pad(w, pad), torch.nn.functional.pad(cum, pad), keys,
            memory, ask.maskadd_of(mask), ap)


ATTENTION_SHAPES = {
    "tiny": (4, 12, 32, 32, 64, 8), "probe": (96, 100, 128, 512, 1024, 32),
    "train": (32, 64, 128, 768, 1024, 32), "max": (5, 256, 512, 96, 1024, 32),
    # B past the card's clusters, so a cluster takes several rows and the
    # last fewer; S not a multiple of the cluster (the last block's run of
    # positions is short), A / 32 not a power of two, C not a multiple of 8.
    "ragged": (37, 37, 96, 160, 200, 20),
    # A ring shorter than a block's memory chunks (refilled during the step).
    "ring": (96, 256, 128, 512, 1024, 32),
}


@pytest.mark.parametrize("masked", [False, True], ids=["open", "masked"])
@pytest.mark.parametrize("shape", list(ATTENTION_SHAPES))
def test_attention_step_kernel(dev, shape, masked):
    """One fused step against its plain version: f32 on both sides, sums in
    another order (the one-step gate of chip_smoke.py, 1e-4 of the peak)."""
    from multi_speaker_tts_tpu_torch.ops import attention_step_kernel as ask

    args = _attention_case(dev, *ATTENTION_SHAPES[shape], seed=len(shape), masked=masked,
                           scale=0.5 if shape == "tiny" else 0.1)
    got = ask.attention_step_kernel(*args)
    want = ask.attention_step_plain(*args)
    assert max(_rel_peak(g, w) for g, w in zip(got, want)) <= 1e-4
    if masked:
        S = args[3].shape[1]
        assert float(got[0][:, 2 * S // 3:].abs().max()) == 0.0


def test_attention_step_kernel_rows_per_block_agree(dev):
    """A row's outputs do not depend on how many rows its cluster takes: the
    probe's batch (several rows a cluster) against its first 7 and its last
    rows alone (one a cluster), bit for bit; and a repeat is bit-equal."""
    from multi_speaker_tts_tpu_torch.ops import attention_step_kernel as ask

    args = _attention_case(dev, 96, 100, 128, 512, 1024, 32, seed=5, masked=True)
    B, S, A = args[3].shape
    assert ask.kernel_plan(B, S, A, 512, 31, 32, ask.max_clusters(dev))["R"] > 1
    full = ask.attention_step_kernel(*args)
    again = ask.attention_step_kernel(*args)
    assert all(torch.equal(a, b) for a, b in zip(full, again))
    for rows in (slice(0, 7), slice(95, 96)):
        part = ask.attention_step_kernel(*(t[rows] for t in args[:6]), args[6])
        assert all(torch.equal(a[rows], b) for a, b in zip(full, part))


@pytest.mark.parametrize("shape", list(ATTENTION_SHAPES))
def test_attention_step_smem_mirror(dev, shape):
    """The wrapper's copy of the kernel's shared-memory layout equals the
    kernel's own at the plan the wrapper launches."""
    import ctypes

    from multi_speaker_tts_tpu_torch.ops import attention_step_kernel as ask

    B, S, A, D, H, C = ATTENTION_SHAPES[shape]
    plan = ask.kernel_plan(B, S, A, D, 31, C, ask.max_clusters(dev))
    dims = (ctypes.c_int * 8)(S, A, D, 31, C, plan["R"], plan["chunk"], plan["slots"])
    out = ctypes.c_longlong(0)
    ask.KERNEL.lib().mstts_attention_smem_bytes(dims, ctypes.byref(out))
    assert out.value == plan["smem"] <= ask.SMEM_LIMIT


def test_attention_kernel_loop_launches_once_a_step(dev, monkeypatch):
    from multi_speaker_tts_tpu_torch.ops import attention_step_kernel as ask
    from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan
    from multi_speaker_tts_tpu_torch.tools import attention_probe as probe

    args = probe.parser().parse_args(["-B", "8", "-S", "40"])
    ap, keys, memory, mask, h0, w0, cum0 = probe.probe_inputs(args, 0, dev)

    def boom(*a, **k):
        raise AssertionError("the plain attention step ran in the kernel loop")

    monkeypatch.setattr(dscan, "attention_block", boom)
    monkeypatch.setattr(ask, "attention_step_plain", boom)
    before = ask.KERNEL.launches
    got = probe.make_kernel_loop(ap, keys, memory, mask, 3)(h0, w0, cum0)
    torch.cuda.synchronize()
    assert ask.KERNEL.launches - before == 3
    monkeypatch.undo()
    want = probe.make_plain_loop(ap, keys, memory, mask, 3)(h0, w0, cum0)
    assert max(_rel_peak(g, w) for g, w in zip(got, want)) <= 1e-4


def test_attention_step_kernel_raises_on_unsupported_shapes(dev):
    from multi_speaker_tts_tpu_torch.ops import attention_step_kernel as ask

    args = _attention_case(dev, 2, 12, 48, 32, 64, 8, seed=0)
    with pytest.raises(ValueError, match="multiple of 32"):
        ask.attention_step(*args)


def test_attention_step_kernel_raises_past_the_cards_shared_memory(dev):
    """D 65536: one memory position of a block's ring is 256 KB, more than
    the 227 KB an H100 block may have: the wrapper refuses with its reason."""
    from multi_speaker_tts_tpu_torch.ops import attention_step_kernel as ask

    args = _attention_case(dev, 2, 12, 32, 65536, 64, 8, seed=0)
    before = ask.KERNEL.launches
    with pytest.raises(ValueError, match="bytes of shared memory"):
        ask.attention_step(*args)
    assert ask.KERNEL.launches == before


def test_daemon_serves_the_workers_bytes_on_the_card(dev):
    """One /synthesize on the small checkpoint on the card: the wav bytes the
    client receives are those of the row the worker's own synthesize call
    returned, and a direct synthesize of the same request decodes the same
    mel length (one request, one answer)."""
    import base64
    import json
    import urllib.request

    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.serve import TTSServer, _wav_bytes

    synth = Synthesizer.from_compact(str(ROOT / "demo" / "serving_ckpt.msgpack"), device=dev)
    calls, original = [], synth.synthesize

    def recorded(texts, *args, **kwargs):
        out = original(texts, *args, **kwargs)
        calls.append((list(texts), args, kwargs, out))
        return out

    synth.synthesize = recorded
    srv = TTSServer(synth, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=5.0)
    srv.registry.enroll("spk0", [str(ROOT / "demo" / "enroll_spk0_utt0.wav")])
    srv.start_background()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/synthesize", method="POST",
            data=json.dumps({"text": "hello from the card.", "speaker": "spk0"}).encode())
        with urllib.request.urlopen(req, timeout=300) as resp:
            assert resp.status == 200
            out = json.loads(resp.read())
    finally:
        srv.shutdown()
    texts, args, kwargs, results = calls[-1]
    assert texts == ["hello from the card."]
    wav = base64.b64decode(out["wav_b64"])
    assert wav == _wav_bytes(results[0]["wav"], synth.dsp_cfg.sample_rate)
    again = original(texts, *args, **kwargs)
    assert again[0]["mel_length"] == results[0]["mel_length"] == out["mel_length"]


# -- data parallelism and sharded synthesis on the card ------------------------

SMALL_CKPT = ROOT / "demo" / "serving_ckpt.msgpack"
DP_ROWS = 8


def _dp_hp():
    from multi_speaker_tts_tpu_torch.checkpoints import load_compact
    from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse

    params, batch_stats, meta = load_compact(SMALL_CKPT)
    hp = Recursive_Parse(meta["hp"]).replace(Speaker_Embedding={"GE2E": {"Freeze": False}},
                                             Train={"Batch_Size": DP_ROWS})
    return hp, params, batch_stats


def _dp_card_rank(rank, world, init, backend, out):
    """One rank of the card's data-parallel test, in a spawned process: the
    small checkpoint (GE2E trainable, every dropout on), this rank's rows
    of the 8-row batch, two steps; launches and plain backward calls
    counted. Any error exits non-zero."""
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel, lstm_kernel
    from multi_speaker_tts_tpu_torch.parallel import multihost
    from multi_speaker_tts_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = multihost.initialize_distributed(init, world, rank, backend=backend, device="cuda")
    plain = []
    for mod, name in ((lstm_kernel, "lstm_seq_layer_bwd_plain"),
                      (birnn_kernel, "bilstm_bwd_plain")):
        setattr(mod, name, lambda *a, _o=getattr(mod, name), _n=name, **k:
                plain.append(_n) or _o(*a, **k))
    kernels = (lstm_kernel.RES_KERNEL, lstm_kernel.BWD_KERNEL, birnn_kernel.RES_KERNEL,
               birnn_kernel.BWD_KERNEL)
    hp, params, batch_stats = _dp_hp()
    rows = multihost.local_rows(DP_ROWS)
    batch = {k: v[rows] for k, v in _train_batch(hp, DP_ROWS).items()}
    trainer = Trainer.from_params(hp, params, batch_stats, device=device, seed=0)
    trainer.sync_state()
    before = [k.launches for k in kernels]
    metrics = [trainer.train_step(batch) for _ in range(2)]
    torch.cuda.synchronize()
    torch.save({"device": str(device), "metrics": metrics, "plain": plain,
                "launches": [k.launches - b for k, b in zip(kernels, before)],
                "grads": trainer.gradients(batch)[1],
                "state": {n: p.detach().cpu() for n, p in zip(trainer.param_names,
                                                              trainer.params)}},
               f"{out}/rank{rank}.pt")
    multihost.shutdown()


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_data_parallel_step_on_the_card(dev, backend, tmp_path):
    """Two ranks (gloo: both on cuda:0; NCCL: one card a rank) against the
    single-process steps on the same 8 rows on the card: the losses within
    1e-2 and the gradient norm within 2e-2 (bf16 roundings flip with the
    summation orders), the summed gradients of a third forward within 5e-2
    of the largest; the ranks bit-equal; every backward on its kernel."""
    import multiprocessing as mp

    from multi_speaker_tts_tpu_torch.train.trainer import Trainer

    if backend == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip(f"NCCL takes one card a rank: {torch.cuda.device_count()} card(s) here")
    hp, params, batch_stats = _dp_hp()
    batch = _train_batch(hp, DP_ROWS)
    ref = Trainer.from_params(hp, params, batch_stats, seed=0)
    want = [ref.train_step(batch) for _ in range(2)]
    ref_grads = ref.gradients(batch)[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dp_card_rank, args=(r, 2, f"file://{tmp_path}/rdv", backend,
                                                      str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert codes == [0, 0]
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert [g["device"] for g in got] == (["cuda:0", "cuda:1"] if backend == "nccl"
                                          else ["cuda:0", "cuda:0"])
    layers = hp.Speaker_Embedding.GE2E.LSTM.Stacks
    for g in got:  # a step: the GE2E layers' residual forward and backward, the BiLSTM's
        assert g["plain"] == [] and g["launches"] == [2 * layers, 2 * layers, 2, 2]
        assert g["metrics"] == got[0]["metrics"]
        for n, t in g["state"].items():
            assert torch.equal(t, got[0]["state"][n]), n
    for m, w in zip(got[0]["metrics"], want):
        assert not m["skipped_nonfinite"]
        for k in w:
            if k != "skipped_nonfinite":
                assert abs(m[k] - w[k]) <= (2e-2 if k == "grad_norm" else 1e-2) * abs(w[k]), k
    scale = max(np.abs(g).max() for g in ref_grads.values())
    for n, g in ref_grads.items():
        assert np.abs(got[0]["grads"][n] - g).max() <= 5e-2 * scale, n


def test_sharded_synthesis_on_the_card(dev):
    """A mesh of two entries (two cards, or cuda:0 twice): the small
    checkpoint under ``int8_pallas``, sharded against unsharded: equal
    lengths, mels within 5e-2, the decode kernel launched in each shard."""
    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.ops import decode_kernel

    n = torch.cuda.device_count()
    mesh = [torch.device("cuda", i % n) for i in range(2)]
    synth = Synthesizer.from_compact(str(SMALL_CKPT), quantize="int8_pallas", mesh=mesh)
    emb = synth.enroll([str(ROOT / "demo" / "enroll_spk0_utt0.wav")])
    texts = ["hello world.", "a b c", "the quick brown fox.", "one more sentence here."]
    whole = synth.synthesize(texts, emb, pcm16=True)
    before = decode_kernel.KERNELS["int8"].launches
    sharded = synth.synthesize(texts, emb, pcm16=True, sharded=True)
    assert decode_kernel.KERNELS["int8"].launches > before
    for a, b in zip(whole, sharded):
        assert a["mel_length"] == b["mel_length"]
        assert np.abs(a["mel"] - b["mel"]).max() <= 5e-2
        assert b["wav"].dtype == np.int16 and b["wav"].shape == a["wav"].shape


def _recurrence_kernels():
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel, lstm_kernel

    return (lstm_kernel.KERNEL, lstm_kernel.RES_KERNEL, lstm_kernel.BWD_KERNEL,
            birnn_kernel.KERNEL, birnn_kernel.RES_KERNEL, birnn_kernel.BWD_KERNEL,
            birnn_kernel.GRU_KERNEL, birnn_kernel.GRU_RES_KERNEL, birnn_kernel.GRU_BWD_KERNEL)


@pytest.mark.parametrize("grad", [False, True], ids=["inference", "autograd"])
def test_f32_dispatch_takes_the_references_route_on_the_card(dev, grad, capsys):
    """An f32 compute dtype through the three dispatchers on CUDA tensors:
    no recurrence kernel launches (forward, residual mode or backward); the
    outputs, and under autograd the gradients, equal the same calls on the
    CPU within 1e-4 of their peaks (f32, no TF32)."""
    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel, lstm_kernel
    from multi_speaker_tts_tpu_torch.ops.gru import GRUParams

    rng = np.random.default_rng(5)

    def arr(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    B, T, D, H = 4, 19, 80, 128
    stack = [[arr(D, 4 * H), arr(H, 4 * H), arr(4 * H)], [arr(H, 4 * H), arr(H, 4 * H), arr(4 * H)]]
    bil = [[arr(D, 4 * H), arr(H, 4 * H), arr(4 * H)] for _ in range(2)]
    big = [[arr(D, 3 * H), arr(H, 3 * H), arr(3 * H), arr(3 * H)] for _ in range(2)]
    x = arr(B, T, D)
    calls = {
        "ge2e_lstm": lambda w, xx: lstm_kernel.lstm_stack_seq(
            [LSTMParams(*p) for p in w], xx, torch.float32)[1],
        "bilstm": lambda w, xx: birnn_kernel.bilstm(LSTMParams(*w[0]), LSTMParams(*w[1]), xx,
                                                    torch.float32),
        "bigru": lambda w, xx: birnn_kernel.bigru(GRUParams(*w[0]), GRUParams(*w[1]), xx,
                                                  torch.float32),
    }
    dsp._DISPATCH_LOGGED.clear()
    counts = [k.launches for k in _recurrence_kernels()]
    for name, weights in (("ge2e_lstm", stack), ("bilstm", bil), ("bigru", big)):
        results = []
        for device in (dev, torch.device("cpu")):
            w = [[torch.from_numpy(a).to(device).requires_grad_(grad) for a in p]
                 for p in weights]
            xx = torch.from_numpy(x).to(device).requires_grad_(grad)
            out = calls[name](w, xx)
            grads = []
            if grad:
                (out * torch.cos(torch.arange(out.numel(), device=device).reshape(out.shape)
                                 * 0.01)).sum().backward()
                grads = [t.grad for p in w for t in p] + [xx.grad]
            results.append([t.detach().cpu() for t in (out, *grads)])
        for a, b in zip(*results):
            assert (a - b).abs().max() <= 1e-4 * b.abs().max(), name
    torch.cuda.synchronize()
    assert [k.launches for k in _recurrence_kernels()] == counts
    printed = capsys.readouterr().out
    for name in ("ge2e_lstm", "bilstm", "bigru"):
        assert f"[dispatch] {name} -> plain" in printed


def test_recurrence_wrappers_still_raise_on_f32_cuda_inputs(dev):
    """The capability rule lives at the dispatchers: each kernel wrapper
    called directly with an f32 compute dtype on CUDA tensors raises, and
    launches nothing."""
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel, lstm_kernel
    from multi_speaker_tts_tpu_torch.ops.gru import GRUParams

    T, B, H = 5, 2, 128
    z = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
    p = LSTMParams(z(H, 4 * H), z(H, 4 * H), z(4 * H))
    g = GRUParams(z(H, 3 * H), z(H, 3 * H), z(3 * H), z(3 * H))
    counts = [k.launches for k in _recurrence_kernels()]
    f32 = torch.float32
    for call in (
        lambda: lstm_kernel.lstm_seq_layer_fwd(p, z(T, B, H), f32),
        lambda: lstm_kernel.lstm_seq_layer_bwd(p.w_hh, z(T, B, 4 * H), z(T, B, H), None,
                                               z(T, B, H), f32),
        lambda: birnn_kernel.bilstm_recurrence(z(T, B, 4 * H), z(T, B, 4 * H), p.w_hh, p.w_hh,
                                               f32),
        lambda: birnn_kernel.bilstm_bwd(*[z(T, B, n) for n in (4 * H, H, 4 * H, H)], p.w_hh,
                                        p.w_hh, z(T, B, H), z(T, B, H), f32),
        lambda: birnn_kernel.bigru_recurrence(z(T, B, 3 * H), z(T, B, 3 * H), g, g, f32),
        lambda: birnn_kernel.bigru_bwd(*[z(T, B, n) for n in (3 * H, 3 * H, H)] * 2, g.w_hh,
                                       g.w_hh, z(T, B, H), z(T, B, H), f32),
    ):
        with pytest.raises(NotImplementedError, match="bf16"):
            call()
    assert [k.launches for k in _recurrence_kernels()] == counts


def test_convert_round_trip_on_the_card(dev, tmp_path):
    """A tiny reference torch checkpoint (f32, prenet dropout 0) converted
    through the CLI and served on the card: the converted port model's
    teacher-forced forward on the card equals the reference's there (1e-4 of
    each output's peak, TF32 off), and ``Synthesizer.from_compact`` enrolls and
    decodes on the card."""
    from multi_speaker_tts_tpu_torch.convert.__main__ import main as convert_main
    from multi_speaker_tts_tpu_torch.convert.mapping import convert_full_checkpoint
    from multi_speaker_tts_tpu_torch.convert.reference_torch import (
        build_reference_ge2e, build_reference_tacotron, save_reference_checkpoint,
    )
    from multi_speaker_tts_tpu_torch.hparams import tiny_test_hparams
    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.tools.torch_parity import converted_models

    hp = tiny_test_hparams().replace(Decoder={"Prenet": {"Dropout_Rate": 0.0}},
                                     Linear_Head={"Type": "CBHG"})
    torch.manual_seed(7)
    taco, ge2e = build_reference_tacotron(hp).eval(), build_reference_ge2e(hp).eval()
    src = tmp_path / "S_5.pt"
    save_reference_checkpoint(str(src), taco, ge2e, steps=5)
    hp_json = tmp_path / "hp.json"
    hp_json.write_text(__import__("json").dumps(hp.to_dict()))
    convert_main(["-in", str(src), "-hp", str(hp_json), "-out", str(tmp_path / "c.msgpack")])
    tree = convert_full_checkpoint(str(src), hp)
    taco_p, ge2e_p = converted_models(tree, hp, dev)
    taco, ge2e = taco.to(dev), ge2e.to(dev)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(1, 20, (2, 12))).long().to(dev)
    lengths = torch.tensor([12, 9], device=dev)
    mels = torch.from_numpy(rng.random((2, 16, hp.Sound.Mel_Dim), np.float32)).to(dev)
    refs = torch.from_numpy(rng.random((2, hp.Speaker_Embedding.GE2E.Window_Length,
                                        hp.Sound.Mel_Dim), np.float32)).to(dev)
    with torch.no_grad():
        spk_t, spk_p = ge2e(refs), ge2e_p(refs)
        want, got = taco(tokens, lengths, mels, spk_t), taco_p(tokens, lengths, mels, spk_p)
    assert (spk_p - spk_t).abs().max() <= 1e-4 * spk_t.abs().max()
    for k in ("mel_pre", "mel_post", "stop_logits", "alignments", "linear"):
        assert (got[k] - want[k]).abs().max() <= 1e-4 * want[k].abs().max(), k
    synth = Synthesizer.from_compact(str(tmp_path / "c.msgpack"))
    assert synth.device.type == "cuda"
    emb = synth.enroll([rng.standard_normal(4096).astype(np.float32)])
    out = synth.synthesize(["converted"], emb, max_steps=8, vocode=False)[0]
    assert out["mel_length"] >= 1 and np.isfinite(out["mel"]).all()


# -- every batch and width the reference's gates admit -------------------------


def test_lstm_bwd_in_row_groups_at_the_ge2e_batch(dev):
    """GE2E's published batch, 64 speakers x 10 utterances = 640 rows of a
    768-wide layer over 160 frames: the reverse kernel launches once a row
    group its shared memory sizes (352 + 288 on an H100; the card takes the
    plan's group and refuses one row more), holds within 1e-2 of the peak
    of the plain reverse pass, and the rows one launch takes whole are
    bit-equal to a one-launch call on those rows alone."""
    from multi_speaker_tts_tpu_torch.ops import _build, lstm_kernel

    B, D, H, T = 640, 768, 768, 160
    card = _build.card_limits(dev)
    rows = lstm_kernel.bwd_rows(1, H, B, card)
    assert 1 <= rows < B
    rng = np.random.default_rng(640)
    p = _lstm(rng, D, H, dev)
    x = torch.from_numpy(rng.normal(size=(T, B, D)).astype(np.float32)).to(dev, torch.bfloat16)
    _, _, _, gates, c_prev = lstm_kernel.lstm_seq_layer_kernel(p, x, save_residuals=True)
    d_hT = torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32)).to(dev)
    d_ys = torch.from_numpy(rng.normal(size=(T, B, H)).astype(np.float32) * 0.1).to(dev)
    before = lstm_kernel.BWD_KERNEL.launches
    dG = lstm_kernel.lstm_seq_layer_bwd(p.w_hh, gates, c_prev, d_hT, d_ys)
    torch.cuda.synchronize()
    groups = lstm_kernel.bwd_row_groups(1, H, B, card)
    assert len(groups) >= 2 and lstm_kernel.BWD_KERNEL.launches == before + len(groups)
    ref = lstm_kernel.lstm_seq_layer_bwd_plain(p.w_hh, gates, c_prev, d_hT, d_ys)
    assert _rel_peak(dG, ref) <= 1e-2
    g = groups[0]
    alone = lstm_kernel.lstm_seq_layer_bwd(p.w_hh, gates[:, g].contiguous(),
                                           c_prev[:, g].contiguous(), d_hT[g].contiguous(),
                                           d_ys[:, g].contiguous())
    assert torch.equal(alone, dG[:, g])
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    w = _build.packed(lstm_kernel._bf16, p.w_hh)
    assert lstm_kernel.BWD_KERNEL.lib().mstts_lstm_layer_bwd(
        gates.data_ptr(), c_prev.data_ptr(), w.data_ptr(), None, None, dG.data_ptr(),
        bar.data_ptr(), T, B, H, 0, rows + 1, _build.stream_ptr(gates)) != 0


def test_bilstm_bwd_in_row_groups(dev):
    """The BiLSTM's reverse kernel past one launch's rows (512 at H 256 on
    an H100): 640 rows in two launches, within 1e-2 of the plain passes;
    one row more than the plan's group is refused."""
    from multi_speaker_tts_tpu_torch.ops import _build, birnn_kernel, lstm_kernel

    B, S, H = 640, 24, 256
    groups = lstm_kernel.bwd_row_groups(2, H, B, _build.card_limits(dev))
    assert len(groups) == 2
    rng = np.random.default_rng(5)
    pf, pb = _lstm(rng, 512, H, dev), _lstm(rng, 512, H, dev)
    x = torch.from_numpy(rng.normal(size=(B, S, 512)).astype(np.float32)).to(dev)
    gxf, gxb = birnn_kernel.bilstm_hoist(pf, pb, x, torch.bfloat16)
    got = birnn_kernel.bilstm_recurrence_kernel(gxf, gxb, pf.w_hh, pb.w_hh, save_residuals=True)
    dyf, dyb = (torch.from_numpy(rng.normal(size=(S, B, H)).astype(np.float32)).to(dev)
                for _ in range(2))
    args = (*got[2:], pf.w_hh, pb.w_hh, dyf, dyb)
    before = birnn_kernel.BWD_KERNEL.launches
    dG = birnn_kernel.bilstm_bwd(*args)
    torch.cuda.synchronize()
    assert birnn_kernel.BWD_KERNEL.launches == before + 2
    for a, b in zip(dG, birnn_kernel.bilstm_bwd_plain(*args)):
        assert _rel_peak(a, b) <= 1e-2
    whf, whb = (_build.packed(birnn_kernel._bf16, w) for w in (pf.w_hh, pb.w_hh))
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (*got[2:], whf, whb, dyf, dyb, *dG, bar)]
    assert birnn_kernel.BWD_KERNEL.lib().mstts_bilstm_bwd(
        *ptrs, S, B, H, 0, groups[0].stop + 1, _build.stream_ptr(dyf)) != 0


@pytest.mark.parametrize("B", [1, 4, 33])
@pytest.mark.parametrize("H", [208, 256, 384, 512, 1024, 1248, 1280, 2048, 4096])
def test_bigru_wide_route(dev, H, B):
    """Past H 192 both directions run csrc/bigru_wide.cu (past H 1,184 the
    streamed build): forward, residual mode and backward within the narrow
    kernels' tolerances of the plain versions (h 5e-3, gh and dG 1e-2 of
    the peak), bit-equal on a repeat; launches counted a row group."""
    from multi_speaker_tts_tpu_torch.ops import _build, birnn_kernel
    from multi_speaker_tts_tpu_torch.ops.gru import GRUParams

    card = _build.card_limits(dev)
    rng = np.random.default_rng(B * H)
    scale = 0.1 * (128 / H) ** 0.5  # the recurrent sums at the narrow tests' size

    def gru(D):
        return GRUParams(*(torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32)).to(dev)
                           for s, sc in (((D, 3 * H), 0.1), ((H, 3 * H), scale),
                                         ((3 * H,), 0.1), ((3 * H,), 0.1))))

    pf, pb = gru(128), gru(128)
    T = 37
    x = torch.from_numpy(rng.normal(size=(B, T, 128)).astype(np.float32)).to(dev)
    gxf, gxb = birnn_kernel.bigru_hoist(pf, pb, x, torch.bfloat16)
    for residuals in (False, True):
        kernel = birnn_kernel.WIDE_GRU_RES_KERNEL if residuals else birnn_kernel.WIDE_GRU_KERNEL
        before = kernel.launches
        got = birnn_kernel.bigru_recurrence_kernel(gxf, gxb, pf, pb, residuals)
        again = birnn_kernel.bigru_recurrence_kernel(gxf, gxb, pf, pb, residuals)
        torch.cuda.synchronize()
        n = len(birnn_kernel.wide_row_groups(False, H, B, card))
        assert kernel.launches == before + 2 * n
        want = birnn_kernel.bigru_recurrence_plain(gxf, gxb, pf, pb, torch.bfloat16, residuals)
        for i, (a, b, c) in enumerate(zip(got, again, want)):
            assert torch.equal(a, b) and a.shape == c.shape
            if i in (2, 4):
                assert _rel_peak(a, c) <= 1e-2
            else:
                assert (a.float() - c.float()).abs().max().item() <= 5e-3
    ysf, ysb, ghf, hpf, ghb, hpb = got
    dyf, dyb = (torch.from_numpy(rng.normal(size=(T, B, H)).astype(np.float32)).to(dev)
                for _ in range(2))
    args = (gxf, ghf, hpf, gxb, ghb, hpb, pf.w_hh, pb.w_hh, dyf, dyb)
    before = birnn_kernel.WIDE_GRU_BWD_KERNEL.launches
    dG = birnn_kernel.bigru_bwd(*args)
    torch.cuda.synchronize()
    assert birnn_kernel.WIDE_GRU_BWD_KERNEL.launches == before + len(
        birnn_kernel.wide_row_groups(True, H, B, card))
    for a, b, c in zip(dG, birnn_kernel.bigru_bwd(*args), birnn_kernel.bigru_bwd_plain(*args)):
        assert torch.equal(a, b) and a.shape == c.shape == (T, B, 3 * H)
        assert _rel_peak(a, c) <= 1e-2


@pytest.mark.parametrize("H", [208, 512, 1248, 2048, 4096])
def test_bigru_wide_takes_the_plans_group_and_refuses_one_row_more(dev, H):
    """The wide route's entry points launch the most rows the Python plan
    gives a group (wide_rows, on zero inputs: one step) and refuse one row
    more, forward and backward."""
    from multi_speaker_tts_tpu_torch.ops import _build, birnn_kernel

    lib = birnn_kernel.WIDE_GRU_KERNEL.lib()
    for bwd, fn, n_ptr in ((False, lib.mstts_bigru_wide_fwd, 8),
                           (True, lib.mstts_bigru_wide_bwd, 14)):
        rows = birnn_kernel.wide_rows(bwd, H, 1 << 14, _build.card_limits(dev))
        assert 1 <= rows < 1 << 14
        bufs = [torch.zeros((rows + 1) * 3 * H + 3 * H * H, device=dev) for _ in range(n_ptr)]
        ptrs = [b.data_ptr() for b in bufs] + ([None] * 4 if not bwd else [])
        for n, ok in ((rows, True), (rows + 1, False)):
            bar = torch.zeros(1, dtype=torch.int32, device=dev)
            err = fn(*ptrs, bar.data_ptr(), 1, rows + 1, H, 0, n, _build.stream_ptr(bar))
            assert (err == 0) == ok, (bwd, n, err)
        torch.cuda.synchronize()


def test_bigru_wide_layout_is_the_mirrored_one(dev):
    """``wide_layout`` (Python) against ``mstts_bigru_wide_layout`` on this
    card: the grid, the build, the resident n-tiles, the bytes and the fit
    at every H % 16 from 208 to 4896 and 1-64 rows, both directions."""
    import ctypes

    from multi_speaker_tts_tpu_torch.ops import _build, birnn_kernel

    lib = birnn_kernel.WIDE_GRU_KERNEL.lib()
    card = _build.card_limits(dev)
    out = (ctypes.c_int * 7)()
    for H in range(208, 4897, 16):
        for rows in (1, 8, 32, 33, 64):
            for bwd in (False, True):
                assert lib.mstts_bigru_wide_layout(int(bwd), H, rows, ctypes.addressof(out)) == 0
                got = birnn_kernel.wide_layout(bwd, H, rows, card)
                assert list(out) == [got["U"], got["nblk"], int(got["stream"]), got["ntr"],
                                     got["nt"], got["bytes"], int(got["fits"])], (H, rows, bwd)


# B, S, A, D, H, P, mel, r, K and the mode past H 1024: the weights partly
# streamed, three or four m-tiles of gate rows, gate products deeper than a
# staging piece (H 2048: layer 1's 4,608, in both modes), attention 1024 wide.
WIDE_DECODE = {
    "h1152_bf16": (16, 208, 128, 512, 1152, 256, 80, 2, 4, False),
    "h1536_bf16_b1": (1, 64, 640, 512, 1536, 256, 80, 2, 4, False),
    "h1536_int8": (16, 64, 640, 512, 1536, 256, 80, 2, 4, True),
    "h1664_bf16": (16, 208, 128, 512, 1664, 256, 80, 2, 4, False),
    "h2048_int8": (16, 208, 128, 512, 2048, 256, 80, 2, 4, True),
    "h2048_int8_b1": (1, 64, 128, 512, 2048, 256, 80, 2, 4, True),
    "h2048_bf16": (16, 208, 128, 512, 2048, 256, 80, 2, 4, False),
    "h2048_bf16_b1": (1, 64, 128, 512, 2048, 256, 80, 2, 4, False),
    "a1024_bf16": (16, 64, 1024, 512, 1152, 256, 80, 2, 4, False),
    "a1024_int8_b1": (1, 208, 1024, 512, 1024, 256, 80, 2, 4, True),
}
# B, S, A, D, H in int8 past H 2048: more than four m-tiles of gate rows, in
# passes (five to eight), P 256, mel 80, r 2, K 4.
INT8_PAST_2048 = {"h2176": (16, 208, 128, 512, 2176), "h3072_b1": (1, 256, 640, 512, 3072),
                  "h4096": (4, 64, 128, 512, 4096), "h4096_a1024_b1": (1, 256, 1024, 512, 4096)}


@pytest.mark.parametrize("shape", list(WIDE_DECODE))
def test_decode_segment_kernel_past_h1024(dev, shape):
    """The decode kernel at the widths past its production layout, one
    chunk from the zero state and one from the kernel's own carry: bit-equal
    on a repeat, one launch a row group, and within the production gate of
    the plain version (frames, stops, state 1e-2, aligns 1e-3)."""
    from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk
    from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan

    B, S, A, D, H, P, mel, r, K, quantize = WIDE_DECODE[shape]
    rng = np.random.default_rng(11)
    p, prenet = _decoder(rng, dev, H, D, P, A, mel, r)
    bundle = dk.prepare_bundle(p, prenet, quantize=quantize)
    t = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.3).astype(np.float32)).to(dev)  # noqa: E731
    keys, memory = t(B, S, A), t(B, S, D)
    lens = torch.tensor(([S, S - 5, 7, S] * 16)[:B], device=dev)
    mask = (torch.arange(S, device=dev)[None] < lens[:, None]).float()
    keep = [torch.from_numpy(rng.random((K, B, P)) < 0.5).to(dev).float() / 0.5 for _ in range(2)]
    carry = dscan.initial_carry(B, memory, 2, H)
    prev = torch.zeros(B, mel, device=dev)
    kernel = dk.KERNELS["int8" if quantize else "bf16"]
    assert dk._shape_reason(H, D, (P, P), S, A, mel, 32, 31, quantize,
                            dk.card_limits(dev)) is None
    for _ in range(2):
        before = kernel.launches
        got = dk.decode_segment(bundle, keys, memory, mask, carry, prev, *keep, K, mel, r)
        again = dk.decode_segment(bundle, keys, memory, mask, carry, prev, *keep, K, mel, r)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2 * len(dk.kernel_row_groups(bundle, B, S, dev))
        assert all(torch.equal(x, y) for x, y in zip(got[1:], again[1:]))
        want = dk.decode_segment_plain(bundle, keys, memory, mask, carry, prev, *keep, K, mel, r)
        assert (got[2] - want[2]).abs().max().item() <= 1e-2
        assert (got[3] - want[3]).abs().max().item() <= 1e-2
        assert (got[4] - want[4]).abs().max().item() <= 1e-3
        assert (got[1] - want[1]).abs().max().item() <= 1e-2
        for a, b in zip((*got[0].h, *got[0].c, got[0].context),
                        (*want[0].h, *want[0].c, want[0].context)):
            assert a.shape == b.shape and (a - b).abs().max().item() <= 1e-2
        carry, prev = got[0], got[1]


@pytest.mark.parametrize("shape", list(INT8_PAST_2048))
def test_decode_segment_kernel_int8_past_h2048(dev, shape):
    """The int8 decode in passes of four m-tiles, one chunk from the zero
    state and one from the kernel's own carry: bit-equal on a repeat, one
    launch a row group, frames, stops and state within the production gate
    (1e-2) of the plain version, and the alignments held as the K 16 chunk's
    are in chip_smoke.py: every step one at a time from the plain version's
    carry within 1e-3, and the chunk within max(1e-3, 4x the median) of the
    plain version or of one of its 8 probes (its f32 inputs moved by 1e-6):
    an int8 rounding that a summation order flips moves the next steps'
    alignments by ~1e-3 (H 3072, S 256: the plain version's own probes read
    1.2e-3, H100)."""
    from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk
    from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan

    B, S, A, D, H = INT8_PAST_2048[shape]
    P, mel, r, K = 256, 80, 2, 4
    rng = np.random.default_rng(11)
    p, prenet = _decoder(rng, dev, H, D, P, A, mel, r)
    bundle = dk.prepare_bundle(p, prenet, quantize=True)
    t = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.3).astype(np.float32)).to(dev)  # noqa: E731
    keys, memory = t(B, S, A), t(B, S, D)
    lens = torch.tensor(([S, S - 5, 7, S] * 16)[:B], device=dev)
    mask = (torch.arange(S, device=dev)[None] < lens[:, None]).float()
    keep = [torch.from_numpy(rng.random((K, B, P)) < 0.5).to(dev).float() / 0.5 for _ in range(2)]
    carry = dscan.initial_carry(B, memory, 2, H)
    prev = torch.zeros(B, mel, device=dev)
    assert dk.decode_layout(H, dk.card_limits(dev)[0])["mt"] > dk.MAX_M_TILES
    assert dk._shape_reason(H, D, (P, P), S, A, mel, 32, 31, True, dk.card_limits(dev)) is None
    g = torch.Generator(dev).manual_seed(H)

    def nudged(x):
        return x * (1.0 + 1e-6 * torch.randn(x.shape, generator=g, device=dev))

    for _ in range(2):
        before = dk.KERNELS["int8"].launches
        got = dk.decode_segment(bundle, keys, memory, mask, carry, prev, *keep, K, mel, r)
        again = dk.decode_segment(bundle, keys, memory, mask, carry, prev, *keep, K, mel, r)
        torch.cuda.synchronize()
        assert dk.KERNELS["int8"].launches == before + 2 * len(
            dk.kernel_row_groups(bundle, B, S, dev))
        assert all(torch.equal(x, y) for x, y in zip(got[1:], again[1:]))
        want = dk.decode_segment_plain(bundle, keys, memory, mask, carry, prev, *keep, K, mel, r)
        for i in (1, 2, 3):
            assert (got[i] - want[i]).abs().max().item() <= 1e-2
        for a, b in zip((*got[0].h, *got[0].c, got[0].context),
                        (*want[0].h, *want[0].c, want[0].context)):
            assert a.shape == b.shape and (a - b).abs().max().item() <= 1e-2
        c_, p_ = carry, prev
        for k in range(K):
            m1, m2 = keep[0][k:k + 1], keep[1][k:k + 1]
            one = dk.decode_segment(bundle, keys, memory, mask, c_, p_, m1, m2, 1, mel, r)
            ref = dk.decode_segment_plain(bundle, keys, memory, mask, c_, p_, m1, m2, 1, mel, r)
            assert (one[4] - ref[4]).abs().max().item() <= 1e-3, k
            c_, p_ = ref[0], ref[1]
        probes = []
        for _ in range(8):
            cn = dscan.DecoderCarry(tuple(nudged(x) for x in carry.h),
                                    tuple(nudged(x) for x in carry.c), nudged(carry.weights),
                                    nudged(carry.cum_weights), nudged(carry.context))
            probes.append(dk.decode_segment_plain(bundle, nudged(keys), nudged(memory), mask, cn,
                                                  nudged(prev), *keep, K, mel, r)[4])
        limit = max(1e-3, 4 * float(np.median([(q - want[4]).abs().max().item()
                                                for q in probes])))
        nearest = min((got[4] - q).abs().max().item() for q in (want[4], *probes))
        assert nearest <= limit, (nearest, limit)
        carry, prev = got[0], got[1]


@pytest.mark.parametrize("n_fft, hop", [(4, 1), (32, 8), (128, 32), (6000, 1500), (8192, 2048),
                                        (16384, 4096), (32768, 8192), (17000, 4250),
                                        (12, 4)])
def test_mel_kernel_at_any_n_fft(dev, n_fft, hop):
    """Frames outside 256-4096: the FFT route from n_fft 4 and past 4096
    (its global-memory mode past 16384 on an H100), the DFT route at any
    other n_fft (its global-memory mode past 16603), each within 1e-4 of the
    plain version (the f32 DFT matmul; past n_fft 8192, whose table would
    take gigabytes, an f32 rfft), bit-equal on a repeat, one launch a call
    on its own count."""
    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.ops import _build, mel_kernel

    cfg = dsp.DSPConfig(22050, n_fft, hop, 80, 0.0, None, 0.97, -100.0, 20.0, 1.5, 60)
    route, global_mode = mel_kernel.plan(n_fft, _build.card_limits(dev))
    kernel = {("fft", False): mel_kernel.KERNEL, ("dft", False): mel_kernel.DFT_KERNEL,
              ("fft", True): mel_kernel.FFT_GLOBAL_KERNEL,
              ("dft", True): mel_kernel.DFT_GLOBAL_KERNEL}[route, global_mode]
    rng = np.random.default_rng(n_fft)
    T = 7
    for B in (1, 3):
        y_pad = torch.from_numpy((rng.standard_normal((B, (T - 1) * hop + n_fft + B % 2))
                                  * 0.3).astype(np.float32)).to(dev)
        before = kernel.launches
        got = mel_kernel.melspectrogram_kernel(y_pad, T, cfg)
        again = mel_kernel.melspectrogram_kernel(y_pad, T, cfg)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2 and torch.equal(got, again)
        want = mel_kernel.melspectrogram_plain(y_pad, T, cfg)
        assert (got - want).abs().max().item() <= 1e-4


# -- the LSTM family at every width the JAX gate admits --------------------------


def test_lstm_layouts_are_the_kernels(dev):
    """``fwd_layout`` and ``bwd_layout`` (the Python copies of lstm_layout and
    lstm_bwd_layout) against the kernels' own on this card: route, resident
    tiles, bytes and fit over widths 64-4096, both layer kinds and the
    BiLSTM, several batches and row counts."""
    import ctypes

    from multi_speaker_tts_tpu_torch.ops import _build, lstm_kernel

    card = _build.card_limits(dev)
    out = (ctypes.c_int * 6)()
    fwd, bwd = lstm_kernel.KERNEL.lib(), lstm_kernel.BWD_KERNEL.lib()
    keys = ("U", "nblk", "wide", "ntr", "bytes", "fits")
    for H in [*range(64, 4097, 64), 776, 904, 1000, 1208, 1328, 1064, 1680, 8448, 8456]:
        for ndir, D in ((1, H), (1, 80), (2, 0)):
            for B, rows in ((32, 32), (32, 16), (8, 8), (640, 32), (1, 1), (40, 33)):
                assert fwd.mstts_lstm_fwd_layout(ndir, D, H, B, rows, ctypes.addressof(out)) == 0
                want = lstm_kernel.fwd_layout(ndir, D, H, B, rows, card)
                assert list(out) == [int(want[k]) for k in keys], (ndir, D, H, B, rows)
        for ndir in (1, 2):
            for B, rows in ((32, 32), (8, 8), (640, 210), (640, 352), (1, 1)):
                assert bwd.mstts_lstm_bwd_layout(ndir, H, B, rows, ctypes.addressof(out)) == 0
                want = lstm_kernel.bwd_layout(ndir, H, B, rows, card)
                assert list(out) == [int(want[k]) for k in keys], (ndir, H, B, rows)


@pytest.mark.parametrize("B, D, H, T", [(32, 1152, 1152, 24), (32, 80, 1664, 24),
                                        (32, 80, 1792, 24), (40, 1792, 1792, 24),
                                        (3, 1160, 1160, 7), (16, 80, 4096, 5)])
def test_lstm_wide_route_and_backward(dev, B, D, H, T):
    """#2 / #2r past the resident weights (W_ih from L2; past H 1328 W_hh
    tiles streamed) and #8 past one row, against the plain versions: ys,
    h_T and c_T within 5e-3, or within the plain bf16 version's own distance
    from its f32 version where that is larger (at these widths a few bf16
    rounding flips of h grow through the recurrence, and the kernel's sums
    run in another order: both are bf16 trajectories of one f32 recurrence);
    every output and dG within 1e-2 of the peak (the residual mode's and the
    backward's production gate). The residual mode's ys equal the inference
    mode's, a repeat is bit-equal, one launch a row group of each."""
    from multi_speaker_tts_tpu_torch.ops import _build, lstm_kernel

    card = _build.card_limits(dev)
    rng = np.random.default_rng(B + D + H)
    p = _lstm(rng, D, H, dev, scale=0.1 * (768 / H) ** 0.5)
    x = torch.from_numpy(rng.normal(size=(T, B, D)).astype(np.float32)).to(dev, torch.bfloat16)
    rows = lstm_kernel.fwd_rows(1, D, H, B, card)
    assert lstm_kernel.fwd_layout(1, D, H, B, rows, card)["wide"]
    n_fwd = len(lstm_kernel.fwd_row_groups(1, D, H, B, card))
    before = (lstm_kernel.KERNEL.launches, lstm_kernel.RES_KERNEL.launches)
    inf = lstm_kernel.lstm_seq_layer_kernel(p, x)
    got = lstm_kernel.lstm_seq_layer_kernel(p, x, save_residuals=True)
    again = lstm_kernel.lstm_seq_layer_kernel(p, x, save_residuals=True)
    torch.cuda.synchronize()
    assert (lstm_kernel.KERNEL.launches - before[0],
            lstm_kernel.RES_KERNEL.launches - before[1]) == (n_fwd, 2 * n_fwd)
    want = lstm_kernel.lstm_seq_layer_plain(p, x, torch.bfloat16, save_residuals=True)
    f32 = lstm_kernel.lstm_seq_layer_plain(p, x, torch.float32)
    drift = max((u.float() - v.float()).abs().max().item() for u, v in zip(want[:3], f32))
    tol = max(5e-3, drift)
    assert torch.equal(inf[0], got[0])
    for i, (a, b, c) in enumerate(zip(got, again, want)):  # ys, h_T, c_T, gates, c_prev
        assert torch.equal(a, b) and a.shape == c.shape
        if i < 3:
            assert (a.float() - c.float()).abs().max().item() <= tol, (i, drift)
        assert _rel_peak(a, c) <= 1e-2, i
    gates, c_prev = got[3], got[4]
    d_hT = torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32)).to(dev)
    d_ys = torch.from_numpy(rng.normal(size=(T, B, H)).astype(np.float32)).to(dev)
    n_bwd = len(lstm_kernel.bwd_row_groups(1, H, B, card))
    before = lstm_kernel.BWD_KERNEL.launches
    dG = lstm_kernel.lstm_seq_layer_bwd(p.w_hh, gates, c_prev, d_hT, d_ys)
    torch.cuda.synchronize()
    assert lstm_kernel.BWD_KERNEL.launches == before + n_bwd
    ref = lstm_kernel.lstm_seq_layer_bwd_plain(p.w_hh, gates, c_prev, d_hT, d_ys)
    assert _rel_peak(dG, ref) <= 1e-2
    assert torch.equal(dG, lstm_kernel.lstm_seq_layer_bwd(p.w_hh, gates, c_prev, d_hT, d_ys))


@pytest.mark.parametrize("D, H, B", [(768, 768, 64), (1792, 1792, 40), (80, 1792, 40)])
def test_lstm_forward_group_equals_its_rows_alone(dev, D, H, B):
    """Rows are independent: a row group of a call (production and wide
    layouts) is bit-equal to a call on its rows alone; the entry point takes
    the plan's group and refuses 33 rows."""
    from multi_speaker_tts_tpu_torch.ops import _build, lstm_kernel

    card = _build.card_limits(dev)
    rng = np.random.default_rng(D + H)
    p = _lstm(rng, D, H, dev, scale=0.1 * (768 / H) ** 0.5)
    x = torch.from_numpy(rng.normal(size=(16, B, D)).astype(np.float32)).to(dev, torch.bfloat16)
    groups = lstm_kernel.fwd_row_groups(1, D, H, B, card)
    assert len(groups) == 2
    whole = lstm_kernel.lstm_seq_layer_kernel(p, x, save_residuals=True)
    for g in groups:
        alone = lstm_kernel.lstm_seq_layer_kernel(p, x[:, g].contiguous(), save_residuals=True)
        for i, (a, b) in enumerate(zip(whole, alone)):
            assert torch.equal(a[g] if i in (1, 2) else a[:, g], b), (g, i)
    w, b = _build.packed(lstm_kernel._kernel_layout, p.w_ih, p.w_hh, p.b)
    xg = torch.empty(16, B, 4 * H, device=dev)
    ys = torch.empty(16, B, H, device=dev, dtype=torch.bfloat16)
    for rows, ok in ((groups[0].stop, True), (33, False)):
        bar = torch.zeros(1, dtype=torch.int32, device=dev)
        err = lstm_kernel.KERNEL.lib().mstts_lstm_layer_fwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), xg.data_ptr(), ys.data_ptr(), None, None,
            None, None, bar.data_ptr(), 16, B, D, H, 0, rows, _build.stream_ptr(x))
        assert (err == 0) == ok, (rows, err)
    torch.cuda.synchronize()


@pytest.mark.parametrize("B, S, H", [(8, 24, 1152), (32, 24, 1152), (3, 9, 1160), (2, 5, 4096)])
def test_bilstm_wide_route_and_backward(dev, B, S, H):
    """#3 / #3r past the resident W_hh (1152 a direction: Encoder.LSTM_Size
    2304; its streamed tiles at 32 rows) and #9 past 16 units a block (the
    wide build): the production tolerances, bit-equal on a repeat, one
    launch a row group."""
    from multi_speaker_tts_tpu_torch.ops import _build, birnn_kernel, lstm_kernel

    card = _build.card_limits(dev)
    rng = np.random.default_rng(S + H)
    sc = 0.1 * (256 / H) ** 0.5
    pf, pb = _lstm(rng, 64, H, dev, sc), _lstm(rng, 64, H, dev, sc)
    x = torch.from_numpy(rng.normal(size=(B, S, 64)).astype(np.float32)).to(dev)
    gxf, gxb = birnn_kernel.bilstm_hoist(pf, pb, x, torch.bfloat16)
    rows = lstm_kernel.fwd_rows(2, 0, H, B, card)
    assert lstm_kernel.fwd_layout(2, 0, H, B, rows, card)["wide"]
    n_fwd = len(lstm_kernel.fwd_row_groups(2, 0, H, B, card))
    before = (birnn_kernel.KERNEL.launches, birnn_kernel.RES_KERNEL.launches)
    ysf, ysb = birnn_kernel.bilstm_recurrence_kernel(gxf, gxb, pf.w_hh, pb.w_hh)
    got = birnn_kernel.bilstm_recurrence_kernel(gxf, gxb, pf.w_hh, pb.w_hh, save_residuals=True)
    torch.cuda.synchronize()
    assert (birnn_kernel.KERNEL.launches - before[0],
            birnn_kernel.RES_KERNEL.launches - before[1]) == (n_fwd, n_fwd)
    want = birnn_kernel.bilstm_recurrence_plain(gxf, gxb, pf.w_hh, pb.w_hh, torch.bfloat16,
                                                save_residuals=True)
    assert torch.equal(ysf, got[0]) and torch.equal(ysb, got[1])
    for i, (a, b) in enumerate(zip(got, want)):  # ysf, ysb, gf, cf, gb, cb
        assert a.shape == b.shape and _rel_peak(a, b) <= 1e-2, i
        if i < 2:
            assert (a.float() - b.float()).abs().max().item() <= 5e-3, i
    dyf, dyb = (torch.from_numpy(rng.normal(size=(S, B, H)).astype(np.float32)).to(dev)
                for _ in range(2))
    args = (*got[2:], pf.w_hh, pb.w_hh, dyf, dyb)
    assert lstm_kernel.bwd_layout(2, H, B, lstm_kernel.bwd_rows(2, H, B, card), card)["wide"]
    before = birnn_kernel.BWD_KERNEL.launches
    dG = birnn_kernel.bilstm_bwd(*args)
    torch.cuda.synchronize()
    assert birnn_kernel.BWD_KERNEL.launches == before + len(
        lstm_kernel.bwd_row_groups(2, H, B, card))
    for a, b, c in zip(dG, birnn_kernel.bilstm_bwd(*args), birnn_kernel.bilstm_bwd_plain(*args)):
        assert torch.equal(a, b) and _rel_peak(a, c) <= 1e-2


def test_lstm_bwd_wide_in_row_groups(dev):
    """#8 at H 1792 over 640 rows: the wide build in groups of the plan's
    rows (every W_hh tile from L2), within 1e-2 of the plain reverse pass;
    the first group bit-equal to a call on its rows alone; one row more
    than the plan's group refused."""
    from multi_speaker_tts_tpu_torch.ops import _build, lstm_kernel

    B, H, T = 640, 1792, 12
    card = _build.card_limits(dev)
    groups = lstm_kernel.bwd_row_groups(1, H, B, card)
    assert len(groups) >= 2 and lstm_kernel.bwd_layout(1, H, B, groups[0].stop, card)["wide"]
    rng = np.random.default_rng(1792)
    p = _lstm(rng, 80, H, dev, scale=0.1 * (768 / H) ** 0.5)
    x = torch.from_numpy(rng.normal(size=(T, B, 80)).astype(np.float32)).to(dev, torch.bfloat16)
    _, _, _, gates, c_prev = lstm_kernel.lstm_seq_layer_kernel(p, x, save_residuals=True)
    d_ys = torch.from_numpy(rng.normal(size=(T, B, H)).astype(np.float32) * 0.1).to(dev)
    before = lstm_kernel.BWD_KERNEL.launches
    dG = lstm_kernel.lstm_seq_layer_bwd(p.w_hh, gates, c_prev, None, d_ys)
    torch.cuda.synchronize()
    assert lstm_kernel.BWD_KERNEL.launches == before + len(groups)
    ref = lstm_kernel.lstm_seq_layer_bwd_plain(p.w_hh, gates, c_prev, None, d_ys)
    assert _rel_peak(dG, ref) <= 1e-2
    g = groups[0]
    alone = lstm_kernel.lstm_seq_layer_bwd(p.w_hh, gates[:, g].contiguous(),
                                           c_prev[:, g].contiguous(), None,
                                           d_ys[:, g].contiguous())
    assert torch.equal(alone, dG[:, g])
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    w = _build.packed(lstm_kernel._bf16, p.w_hh)
    assert lstm_kernel.BWD_KERNEL.lib().mstts_lstm_layer_bwd(
        gates.data_ptr(), c_prev.data_ptr(), w.data_ptr(), None, None, dG.data_ptr(),
        bar.data_ptr(), T, B, H, 0, g.stop + 1, _build.stream_ptr(gates)) != 0


# -- the reference's routes where both gates refuse ------------------------------


@pytest.mark.parametrize("n_fft, hop, T", [(1024, 256, 1300), (4096, 512, 400)])
def test_griffin_lim_routes_to_gemm_where_jax_does(dev, monkeypatch, capsys, n_fft, hop, T):
    """Faults 3.7 and 3.6: past the JAX package's cap for its kernel the
    vocoder runs ``griffin_lim_matmul`` on the card, with its dispatch line
    and no Griffin-Lim launch."""
    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.ops import griffin_lim_kernel as gk
    from multi_speaker_tts_tpu_torch.ops import griffin_lim_staged as gl
    from multi_speaker_tts_tpu_torch.ops import stft_matmul

    monkeypatch.delenv("GL_DENSE_KERNEL", raising=False)
    monkeypatch.setattr(dsp, "_DISPATCH_LOGGED", set())
    mag = torch.from_numpy(np.random.default_rng(T).random((1, T, n_fft // 2 + 1))
                           .astype(np.float32)).to(dev)
    before = (gl.KERNEL.launches, gl.MOM_KERNEL.launches, gk.KERNEL.launches)
    wav = stft_matmul.griffin_lim_auto(mag, n_fft, hop, 4, hop * (T - 1))
    torch.cuda.synchronize()
    assert (gl.KERNEL.launches, gl.MOM_KERNEL.launches, gk.KERNEL.launches) == before
    want = stft_matmul.griffin_lim_matmul(mag, n_fft, hop, 4, hop * (T - 1))
    assert torch.equal(wav, want)
    assert "[dispatch] griffin_lim -> gemm" in capsys.readouterr().out


def test_decode_and_bigru_route_plain_where_jax_does(dev, capsys, tmp_path):
    """A synthesizer with a bf16 decode past H 2048 (fused weights past the
    JAX gate's 80 MB) and a CBHG BiGRU of 1260 a direction (not a multiple
    of 16, nor of 128): both run their plain versions on the card with one
    dispatch line each and no launch of the refused kernel."""
    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.hparams import default_hparams
    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel
    from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk
    from multi_speaker_tts_tpu_torch.train.trainer import Trainer

    hp = default_hparams(Decoder={"LSTM": {"Sizes": 2176}},
                         Linear_Head={"CBHG": {"GRU_Size": 2520}})
    tr = Trainer(hp, checkpoint_dir=str(tmp_path / "ck"), log_dir=str(tmp_path / "log"),
                 device="cuda", seed=0)
    tr.initialize()
    synth = Synthesizer.from_state(hp, tr.checkpoint_state(), quantize="bf16_pallas", seed=0)
    kernels = [*dk.KERNELS.values(), birnn_kernel.GRU_KERNEL, birnn_kernel.WIDE_GRU_KERNEL]
    before = [k.launches for k in kernels]
    dsp._DISPATCH_LOGGED.clear()
    capsys.readouterr()
    out = synth.synthesize(["a routed decode."], np.ones(hp.Speaker_Embedding.Embedding_Size,
                                                         np.float32) / 16.0,
                           max_steps=4, vocode=False)[0]
    assert [k.launches for k in kernels] == before
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("[dispatch]")]
    assert any(x.startswith("[dispatch] decode -> plain") and "2048" in x for x in lines), lines
    assert any(x.startswith("[dispatch] bigru -> plain") and "4880" in x for x in lines), lines
    assert np.isfinite(out["mel"]).all() and out["mel_length"] > 0
