"""What the BiGRU backward and mel kernels take, and the host-side operands
their wrappers build, checked on the CPU: shape reasons, the operand
layouts, the FFT's twiddles and the mel bands. The kernels themselves run
only on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu_torch.audio import dsp
from multi_speaker_tts_tpu_torch.audio.mel_filterbank import mel_filterbank
from multi_speaker_tts_tpu_torch.ops import _build, birnn_kernel, mel_kernel, recurrence_floor

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

def _gru_shapes(T, B, H):
    return (T, B, 3 * H), ((H, 3 * H), (H, 3 * H))


@pytest.mark.parametrize("H", range(16, 193, 16))
def test_bigru_bwd_shape_reason_accepts_the_forwards_widths(H):
    assert birnn_kernel.bigru_bwd_shape_reason(*_gru_shapes(132, 32, H)) is None
    assert birnn_kernel.bigru_shape_reason(*_gru_shapes(132, 32, H)) is None


@pytest.mark.parametrize("H", [8, 72, 200])
def test_bigru_bwd_shape_reason_refuses_other_widths(H):
    reason = birnn_kernel.bigru_bwd_shape_reason(*_gru_shapes(5, 2, H))
    assert reason == f"needs H % 16 == 0 and 16 <= H <= 4880 on this card, got H = {H}"
    assert reason == birnn_kernel.bigru_shape_reason(*_gru_shapes(5, 2, H))


def test_bigru_bwd_shape_reason_refuses_mismatched_weights():
    reason = birnn_kernel.bigru_bwd_shape_reason((5, 2, 384), ((128, 384), (128, 383)))
    assert reason is not None and "(H, 3H) weights" in reason


@pytest.mark.parametrize("H", [16, 128, 192])
def test_bigru_bwd_weight_operand_is_w_hh_exactly(H):
    """The backward kernel's A operand is W_hh (H, 3H) in bf16, row u holding
    unit u's k values: no permutation, so reading it back gives the
    bf16-rounded W_hh element for element."""
    rng = np.random.default_rng(H)
    w = torch.from_numpy(rng.normal(size=(H, 3 * H)).astype(np.float32))
    op = _build.packed(birnn_kernel._bf16, w)
    assert op.dtype == torch.bfloat16 and op.shape == (H, 3 * H) and op.is_contiguous()
    assert torch.equal(op, w.to(torch.bfloat16))
    assert _build.packed(birnn_kernel._bf16, w) is op


def test_bigru_bwd_kernel_checks_shapes_before_any_launch(monkeypatch):
    """On a (pretended) card tensor the wrapper refuses H = 72 with its
    reason, before the library is built or a launch counted; f32 compute
    is refused first, with NotImplementedError."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    T, B, H = 3, 2, 72

    def bf(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16)

    w = torch.zeros(H, 3 * H)
    args = (bf(T, B, 3 * H), bf(T, B, 3 * H), bf(T, B, H)) * 2 + (
        w, w, torch.zeros(T, B, H), torch.zeros(T, B, H))
    before = birnn_kernel.GRU_BWD_KERNEL.launches
    with pytest.raises(ValueError, match="H % 16 == 0 and 16 <= H <= 4880"):
        birnn_kernel.bigru_bwd(*args)
    with pytest.raises(NotImplementedError, match="bf16"):
        birnn_kernel.bigru_bwd(*args, torch.float32)
    assert birnn_kernel.GRU_BWD_KERNEL.launches == before


@pytest.mark.parametrize("n_fft", [4, 32, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 65536])
def test_mel_shape_reason_accepts_powers_of_two_with_dividing_hops(n_fft):
    for hop in (n_fft, n_fft // 2, n_fft // 4, n_fft // 8, 1):
        assert mel_kernel.mel_shape_reason(n_fft, hop) is None or hop == 0


@pytest.mark.parametrize("n_fft", [6, 100, 256, 600, 800, 1000, 1200, 2000, 4000, 6000, 24000])
def test_mel_shape_reason_accepts_any_n_fft_that_hop_divides(n_fft):
    """The kernel takes every n_fft that the JAX rule sends to its kernel
    (hop dividing it), powers of two or not, whatever its size."""
    for hop in (n_fft, n_fft // 2, n_fft // 4, n_fft // 5, 1):
        if n_fft % hop == 0:
            assert mel_kernel.mel_shape_reason(n_fft, hop) is None


@pytest.mark.parametrize("n_fft, hop, why", [
    (255, 10, "hop dividing"), (4100, 3000, "hop dividing"),
    (128, 48, "hop dividing"), (8192, 3000, "hop dividing"),
    (1024, 300, "hop dividing"), (1024, 0, "hop dividing"),
])
def test_mel_shape_reason_refuses(n_fft, hop, why):
    reason = mel_kernel.mel_shape_reason(n_fft, hop)
    assert reason is not None and why in reason


def test_mel_kernel_checks_the_frame_before_any_launch(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    cfg = dsp.DSPConfig(22050, 1000, 300, 80, 0.0, None, 0.97, -100.0, 20.0, 1.5, 60)
    before = mel_kernel.KERNEL.launches, mel_kernel.DFT_KERNEL.launches
    with pytest.raises(ValueError, match="hop dividing"):
        mel_kernel.melspectrogram_kernel(torch.zeros(1, 1000 + 4 * 300), 5, cfg)
    assert (mel_kernel.KERNEL.launches, mel_kernel.DFT_KERNEL.launches) == before


@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048, 4096])
def test_twiddles_are_exact_within_one_f32_ulp(n_fft):
    tw = mel_kernel.twiddles(n_fft)
    assert tw.dtype == np.float32 and tw.shape == (n_fft // 2, 2)
    exact = np.exp(-2j * np.pi * np.arange(n_fft // 2) / n_fft)
    for got, want in ((tw[:, 0], exact.real), (tw[:, 1], exact.imag)):
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert np.all(np.abs(got.astype(np.float64) - want) <= ulp)


@pytest.mark.parametrize("n_fft", [600, 800, 1000, 1200, 4000])
def test_dft_table_is_exact_within_one_f32_ulp(n_fft):
    tab = mel_kernel.dft_table(n_fft)
    assert tab.dtype == np.float32 and tab.shape == (n_fft, 2)
    exact = np.exp(-2j * np.pi * np.arange(n_fft) / n_fft)
    for got, want in ((tab[:, 0], exact.real), (tab[:, 1], exact.imag)):
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert np.all(np.abs(got.astype(np.float64) - want) <= ulp)


@pytest.mark.parametrize("n_fft, hop", [(800, 200), (600, 150), (1000, 250), (1200, 300)])
def test_dft_route_arithmetic_matches_the_plain_version(n_fft, hop):
    """The DFT route's arithmetic, step for step in f32 numpy: the windowed
    frame, each bin's sum over n of x[n] W[(n k) mod N] with the index
    stepped by k and wrapped in integers, the magnitudes, the bands'
    nonzero bins in order, the log and normalisation; within 1e-4 of the
    plain version (the f32 windowed-DFT matmul), the card's tolerance."""
    cfg = dsp.DSPConfig(22050, n_fft, hop, 80, 0.0, None, 0.97, -100.0, 20.0, 1.5, 60)
    T, rng = 9, np.random.default_rng(n_fft)
    y_pad = (rng.standard_normal((2, (T - 1) * hop + n_fft)) * 0.3).astype(np.float32)
    want = mel_kernel.melspectrogram_plain(torch.from_numpy(y_pad), T, cfg).numpy()
    window = dsp.hann_window(n_fft).astype(np.float32)
    tab = mel_kernel.dft_table(n_fft)
    bands, weights = mel_kernel.mel_bands(mel_filterbank(22050, n_fft, 80, 0.0, None))
    F = n_fft // 2 + 1
    k = np.arange(F)
    frames = np.stack([y_pad[:, t * hop:t * hop + n_fft] for t in range(T)], axis=1)
    xw = frames * window  # (2, T, N) f32
    re = np.zeros((2, T, F), np.float32)
    im = np.zeros_like(re)
    idx = np.zeros(F, np.int64)
    for n in range(n_fft):
        re += xw[..., n:n + 1] * tab[idx, 0]
        im += xw[..., n:n + 1] * tab[idx, 1]
        idx += k
        idx[idx >= n_fft] -= n_fft
    mag = np.sqrt(re * re + im * im)
    got = np.zeros((2, T, 80), np.float32)
    for m, (lo, hi, off) in enumerate(bands):
        acc = np.zeros((2, T), np.float32)
        for j in range(lo, hi):
            acc += mag[..., j] * weights[off + j - lo]
        db = 20.0 * np.log10(np.maximum(acc, 1e-5)) - cfg.ref_level_db
        got[..., m] = np.clip((db - cfg.min_level_db) / -cfg.min_level_db, 0.0, 1.0)
    assert np.abs(got - want).max() <= 1e-4


_MEL_KERNELS = {("fft", False): "KERNEL", ("dft", False): "DFT_KERNEL",
                ("fft", True): "FFT_GLOBAL_KERNEL", ("dft", True): "DFT_GLOBAL_KERNEL"}


@pytest.mark.parametrize("n_fft, route, global_mode", [
    (1024, "fft", False), (800, "dft", False), (600, "dft", False), (32, "fft", False),
    (16384, "fft", False), (6000, "dft", False), (32768, "fft", True), (17000, "dft", True),
])
def test_mel_kernel_picks_its_route_by_n_fft(monkeypatch, n_fft, route, global_mode):
    """A power of two takes the FFT entry point with the twiddles, any other
    n_fft the DFT entry point with its full table; past an H100's shared
    memory a block, the route's global-memory mode with a scratch; each
    counts its own launches (the libraries' calls replaced, so this runs
    on the CPU)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    calls = []
    kernels = [getattr(mel_kernel, name) for name in _MEL_KERNELS.values()]
    for kern in kernels:
        monkeypatch.setattr(kern, "lib", lambda kern=kern: type("Lib", (), {
            fn: staticmethod(lambda *a, fn=fn: calls.append((fn, a)) or 0)
            for fn in kern.functions})())
    assert mel_kernel.plan(n_fft) == (route, global_mode)
    hop = n_fft // 4
    cfg = dsp.DSPConfig(22050, n_fft, hop, 80, 0.0, None, 0.97, -100.0, 20.0, 1.5, 60)
    before = [k.launches for k in kernels]
    mel_kernel.melspectrogram_kernel(torch.zeros(1, n_fft + 4 * hop), 5, cfg)
    (fn, args), = calls
    assert fn == {"fft": "mstts_mel_frontend", "dft": "mstts_mel_dft"}[route]
    table = mel_kernel._fft_operands(cfg, torch.device("cpu"))[1]
    assert args[2] == table.data_ptr()
    assert table.shape == ((n_fft // 2, 2) if route == "fft" else (n_fft, 2))
    assert args[7] == int(global_mode) and (args[6] is not None) == global_mode
    after = [k.launches for k in kernels]
    want = getattr(mel_kernel, _MEL_KERNELS[route, global_mode])
    assert [a - b for a, b in zip(after, before)] == [int(k is want) for k in kernels]


@pytest.mark.parametrize("n_mels", [40, 80, 128])
@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048])
def test_mel_bands_cover_every_nonzero(n_fft, n_mels):
    basis = mel_filterbank(22050, n_fft, n_mels, 0.0, None)
    bands, weights = mel_kernel.mel_bands(basis)
    assert bands.shape == (n_mels, 3) and bands.dtype == np.int32
    assert weights.dtype == np.float32 and weights.size == (bands[:, 1] - bands[:, 0]).sum()
    for m, (lo, hi, off) in enumerate(bands):
        assert 0 <= lo <= hi <= basis.shape[1]
        assert not basis[m, :lo].any() and not basis[m, hi:].any()
        np.testing.assert_array_equal(weights[off:off + hi - lo], basis[m, lo:hi])
        if hi > lo:
            assert basis[m, lo] != 0 and basis[m, hi - 1] != 0
    assert np.array_equal(np.cumsum(bands[:-1, 1] - bands[:-1, 0]), bands[1:, 2])


@pytest.mark.parametrize("backward", [False, True])
def test_gru_chain_floors_need_a_card(backward):
    before = recurrence_floor.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        recurrence_floor.gru_chain_floor(4, 4, 128, "cpu", backward=backward)
    assert recurrence_floor.KERNEL.launches == before
