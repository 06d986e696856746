"""The staged Griffin-Lim kernel's plain version (plain and momentum), the
GEMM Griffin-Lim (and its warm start), the FFT route and the vocoder's
routing against the JAX package (interpret-mode Pallas, XLA) on the same
inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.audio import dsp as jdsp
from multi_speaker_tts_tpu.ops import stft_matmul as jstft
from multi_speaker_tts_tpu.ops.griffin_lim_staged import (
    _staged_operands,
    griffin_lim_staged as jax_staged,
)
from multi_speaker_tts_tpu_torch import inference
from multi_speaker_tts_tpu_torch.audio import dsp
from multi_speaker_tts_tpu_torch.ops import griffin_lim_staged as staged
from multi_speaker_tts_tpu_torch.ops import stft_matmul

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

N_FFT, HOP = 1024, 256


@pytest.fixture(scope="module")
def mag():
    rng = np.random.default_rng(0)
    return (rng.random((2, 16, N_FFT // 2 + 1)).astype(np.float32)) ** 2


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-9)


def test_staged_operands_match(mag):
    fwd, inv, win, syn, perm = _staged_operands("float32")
    ops = staged._operands(torch.device("cpu"), torch.float32)
    for g in range(5):
        for a, b in zip(fwd[g], ops["fwd"][g]):
            np.testing.assert_array_equal(b.numpy(), a)
        for a, b in zip(inv[g], ops["inv"][g]):
            np.testing.assert_array_equal(b.numpy(), a)
    np.testing.assert_array_equal(ops["win"].numpy(), win)
    np.testing.assert_array_equal(ops["syn"].numpy(), syn)
    np.testing.assert_array_equal(ops["perm"].numpy(), perm)


@pytest.mark.parametrize("n_iter", [0, 3])
def test_staged_plain_matches_pallas_interpret_f32(mag, n_iter):
    """Same fixed-point map, f32 leaf products on both sides: agreement to
    f32 rounding (the JAX staged-vs-dense test's 1e-4 relative bound)."""
    want = np.asarray(jax_staged(jnp.asarray(mag), N_FFT, HOP, n_iter,
                                 interpret=True, compute_dtype="float32"))
    got = staged.griffin_lim_staged(torch.from_numpy(mag), N_FFT, HOP, n_iter,
                                    compute_dtype=torch.float32).numpy()
    assert got.shape == want.shape == (2, HOP * 15)
    assert _rel(got, want) < 1e-4


def test_staged_plain_bf16_tracks_pallas_interpret_bf16(mag):
    """bf16 leaf operands and stored magnitudes on both sides; operand
    roundings flip where the two f32 sums differ in their last bit, and
    three iterations amplify that to below 1% of the peak."""
    want = np.asarray(jax_staged(jnp.asarray(mag), N_FFT, HOP, 3, interpret=True))
    got = staged.griffin_lim_staged(torch.from_numpy(mag), N_FFT, HOP, 3).numpy()
    assert _rel(got, want) < 1e-2


def test_griffin_lim_matmul_matches_jax(mag):
    length = HOP * (mag.shape[1] - 1)
    want = np.asarray(jstft.griffin_lim_matmul(jnp.asarray(mag), N_FFT, HOP, 4, length))
    got = stft_matmul.griffin_lim_matmul(torch.from_numpy(mag), N_FFT, HOP, 4, length).numpy()
    assert _rel(got, want) < 1e-4


def test_griffin_lim_auto_is_the_matmul_path_on_cpu(mag):
    length = HOP * (mag.shape[1] - 1)
    a = stft_matmul.griffin_lim_auto(torch.from_numpy(mag), N_FFT, HOP, 2, length)
    b = stft_matmul.griffin_lim_matmul(torch.from_numpy(mag), N_FFT, HOP, 2, length)
    assert torch.equal(a, b)


def test_staged_converges_like_the_gemm_path():
    """The staged iteration re-frames the uncropped signal rows, the GEMM
    path the reflect-padded crop: not elementwise equal, but equally
    converged (the JAX package's 5% spectral-convergence gap)."""
    rng = np.random.default_rng(1)
    T = 24
    mag = rng.random((2, T, N_FFT // 2 + 1)).astype(np.float32) ** 2
    length = HOP * (T - 1)
    m = torch.from_numpy(mag)
    wav_st = staged.griffin_lim_staged(m, N_FFT, HOP, 12, compute_dtype=torch.float32)
    wav_mm = stft_matmul.griffin_lim_matmul(m, N_FFT, HOP, 12, length)

    def sc(w):
        D = np.abs(np.asarray(jdsp.stft(jnp.asarray(w.numpy()), N_FFT, HOP)))[:, :T]
        return np.linalg.norm(D - mag) / np.linalg.norm(mag)

    sc_st, sc_mm = sc(wav_st), sc(wav_mm)
    assert abs(sc_st - sc_mm) / sc_mm <= 0.05, (sc_st, sc_mm)


# The staged kernel's per-frame working set: f32 u planes (8 x 128), bf16 z
# operands (8 x 128), bf16 magnitudes (640); its bf16 forward leaves (320 KB)
# come off the budget first.
STAGED_FRAME = 8 * 128 * 4 + 8 * 128 * 2 + 640 * 2
STAGED_LEAVES = 5 * 2 * 128 * 128 * 2


def test_gl_batch_cap_keeps_working_set_in_l2():
    assert stft_matmul.gl_max_batch(128) >= 4
    assert stft_matmul.gl_max_batch(10**6) == 1
    per_row = 128 * STAGED_FRAME
    cap = stft_matmul.gl_max_batch(128)
    assert cap * per_row <= stft_matmul.GL_L2_BUDGET_BYTES - STAGED_LEAVES
    assert (cap + 1) * per_row > stft_matmul.GL_L2_BUDGET_BYTES - STAGED_LEAVES
    assert stft_matmul.GL_L2_BUDGET_BYTES <= 40 << 20


@pytest.mark.parametrize("T", [2, 17, 47, 128, 400, 1000])
@pytest.mark.parametrize("momentum", [0.0, 0.99])
def test_gl_batch_cap_is_the_largest_staged_batch_in_budget(T, momentum):
    """The staged cap at each T is the largest batch whose u planes, z
    operands, magnitudes (and, under momentum, two bf16 previous
    projections) fit beside the leaves."""
    frame = STAGED_FRAME + (2 * 640 * 2 if momentum else 0)
    room = stft_matmul.GL_L2_BUDGET_BYTES - STAGED_LEAVES
    assert stft_matmul.gl_max_batch(T, momentum=momentum) == max(1, room // (T * frame))


def test_gl_batch_cap_models_momentum_and_the_dense_kernel():
    """Momentum adds two bf16 carries of 640 to the staged kernel's frame and
    three f32 carries to the dense kernel's; the dense kernel's matrices come
    off the budget first (16 MB at n_fft 2048)."""
    cap = stft_matmul.gl_max_batch
    budget = stft_matmul.GL_L2_BUDGET_BYTES
    assert cap(128, momentum=0.99) * 128 * (STAGED_FRAME + 2 * 640 * 2) <= budget - STAGED_LEAVES
    assert cap(128, momentum=0.99) < cap(128)
    dense = 128 * (2 * 512 * 4 + 4 + 1024 * 4 + 513 * 4)
    assert cap(128, 1024, 0.0, "dense") * dense <= budget - 4 * 1024 * 512 * 2
    assert cap(128, 1024, 0.99, "dense") < cap(128, 1024, 0.0, "dense")
    assert cap(128, 2048, 0.0, "dense") < cap(128, 1024, 0.0, "dense") >= 4


@pytest.mark.parametrize("kwargs, match", [
    (dict(n_fft=512, hop=256, n_iter=1), "n_fft=1024"),
    (dict(n_fft=1024, hop=200, n_iter=1), "128-multiple"),
    (dict(n_fft=1024, hop=1024, n_iter=1), "even"),
])
def test_staged_refuses_what_it_does_not_take(mag, kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        staged.griffin_lim_staged(torch.from_numpy(mag), **kwargs)


# -- momentum in the staged kernel --------------------------------------------
@pytest.mark.parametrize("n_iter", [1, 3])
def test_staged_momentum_matches_pallas_interpret_f32(mag, n_iter):
    """The TPU kernel's momentum branch (f32 carries in f32 mode)."""
    want = np.asarray(jax_staged(jnp.asarray(mag), N_FFT, HOP, n_iter, interpret=True,
                                 compute_dtype="float32", momentum=0.99))
    got = staged.griffin_lim_staged(torch.from_numpy(mag), N_FFT, HOP, n_iter,
                                    compute_dtype=torch.float32, momentum=0.99).numpy()
    assert _rel(got, want) < 1e-4


def test_staged_momentum_bf16_tracks_pallas_interpret_bf16(mag):
    """bf16 leaves, magnitudes and previous-projection carries on both sides."""
    want = np.asarray(jax_staged(jnp.asarray(mag), N_FFT, HOP, 3, interpret=True, momentum=0.99))
    got = staged.griffin_lim_staged(torch.from_numpy(mag), N_FFT, HOP, 3, momentum=0.99).numpy()
    assert _rel(got, want) < 1e-2


def test_staged_momentum_is_not_the_plain_iteration(mag):
    m = torch.from_numpy(mag)
    plain = staged.griffin_lim_staged(m, N_FFT, HOP, 2, compute_dtype=torch.float32)
    fast = staged.griffin_lim_staged(m, N_FFT, HOP, 2, compute_dtype=torch.float32,
                                     momentum=0.99)
    assert not torch.allclose(plain, fast)
    zero = staged.griffin_lim_staged(m, N_FFT, HOP, 2, compute_dtype=torch.float32, momentum=0.0)
    assert torch.equal(plain, zero)


# -- the GEMM route's warm start ----------------------------------------------
@pytest.mark.parametrize("gate", [None, 0.0, 1.0])
def test_griffin_lim_matmul_warm_start_matches_jax(mag, gate):
    length = HOP * (mag.shape[1] - 1)
    head = np.random.default_rng(4).normal(size=(2, 5 * HOP)).astype(np.float32) * 0.1
    jgate = None if gate is None else jnp.asarray(gate)
    want = np.asarray(jstft.griffin_lim_matmul(jnp.asarray(mag), N_FFT, HOP, 3, length,
                                               momentum=0.99, init_head=jnp.asarray(head),
                                               init_head_gate=jgate))
    got = stft_matmul.griffin_lim_matmul(torch.from_numpy(mag), N_FFT, HOP, 3, length,
                                         momentum=0.99, init_head=torch.from_numpy(head),
                                         init_head_gate=gate).numpy()
    assert _rel(got, want) < 1e-4
    cold = stft_matmul.griffin_lim_matmul(torch.from_numpy(mag), N_FFT, HOP, 3, length,
                                          momentum=0.99).numpy()
    assert (np.array_equal(got, cold)) == (gate == 0.0)


# -- routing -------------------------------------------------------------------
@pytest.mark.parametrize("args, want", [
    ((3, 1024, 256, 47, 256 * 46, True), "staged"),
    ((3, 512, 128, 47, 128 * 46, True), "dense"),
    ((3, 2048, 256, 128, 256 * 127, True), "dense"),
    ((3, 4096, 256, 128, 256 * 127, True), "dense"),  # which raises: wider than it takes
    ((3, 1024, 256, 47, 256 * 46, False), "gemm"),  # a CPU tensor
    ((2, 1024, 256, 47, 256 * 46, True), "gemm"),  # unbatched
    ((3, 1024, 200, 47, 200 * 46, True), "gemm"),  # hop does not divide n_fft
    ((3, 384, 128, 47, 128 * 46, True), "gemm"),  # odd n_fft / hop
    ((3, 512, 64, 47, 64 * 46, True), "gemm"),  # hop not a 128-multiple
    ((3, 1024, 256, 47, 256 * 40, True), "gemm"),  # another length
])
def test_gl_route_follows_the_jax_rule(monkeypatch, args, want):
    monkeypatch.delenv("GL_DENSE_KERNEL", raising=False)
    assert stft_matmul.gl_route(*args, 1, 0.0) == want


def test_gl_dense_kernel_switch(monkeypatch):
    monkeypatch.setenv("GL_DENSE_KERNEL", "1")
    assert stft_matmul.gl_route(3, 1024, 256, 47, 256 * 46, True, 1, 0.0) == "dense"
    assert stft_matmul.gl_route(3, 1024, 256, 47, 256 * 46, False, 1, 0.0) == "gemm"
    monkeypatch.setenv("GL_DENSE_KERNEL", "")
    assert stft_matmul.gl_route(3, 1024, 256, 47, 256 * 46, True, 1, 0.0) == "staged"


def test_griffin_lim_auto_momentum_on_cpu_is_the_matmul_path(mag):
    length = HOP * (mag.shape[1] - 1)
    a = stft_matmul.griffin_lim_auto(torch.from_numpy(mag), N_FFT, HOP, 2, length, momentum=0.99)
    b = stft_matmul.griffin_lim_matmul(torch.from_numpy(mag), N_FFT, HOP, 2, length,
                                       momentum=0.99)
    assert torch.equal(a, b)


# -- the FFT route (hop does not divide n_fft) --------------------------------
FFT_N, FFT_HOP = 1000, 256


@pytest.fixture(scope="module")
def fft_mag():
    rng = np.random.default_rng(3)
    return (rng.random((2, 20, FFT_N // 2 + 1)) ** 2).astype(np.float32)


def test_stft_istft_match_jax():
    rng = np.random.default_rng(5)
    wav = rng.normal(size=(2, FFT_HOP * 19)).astype(np.float32)
    want = np.array(jdsp.stft(jnp.asarray(wav), FFT_N, FFT_HOP))
    got = dsp.stft(torch.from_numpy(wav), FFT_N, FFT_HOP).numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    want_i = np.asarray(jdsp.istft(jnp.asarray(want), FFT_N, FFT_HOP, wav.shape[-1]))
    got_i = dsp.istft(torch.from_numpy(want), FFT_N, FFT_HOP, wav.shape[-1]).numpy()
    assert _rel(got_i, want_i) < 1e-5
    assert _rel(got_i, wav) < 1e-4  # the round trip


@pytest.mark.parametrize("momentum", [0.0, 0.99])
def test_fft_griffin_lim_matches_jax(fft_mag, momentum):
    length = FFT_HOP * (fft_mag.shape[1] - 1)
    want = np.asarray(jdsp.griffin_lim(jnp.asarray(fft_mag), FFT_N, FFT_HOP, 4, length,
                                       momentum=momentum))
    got = dsp.griffin_lim(torch.from_numpy(fft_mag), FFT_N, FFT_HOP, 4, length,
                          momentum=momentum).numpy()
    assert got.shape == want.shape == (2, length)
    assert _rel(got, want) < 1e-4


def test_inv_spectrogram_matches_jax(fft_mag):
    import dataclasses

    from multi_speaker_tts_tpu.hparams import default_hparams

    jcfg = dataclasses.replace(jdsp.DSPConfig.from_hp(default_hparams()), n_fft=FFT_N,
                               hop=FFT_HOP, griffin_lim_iter=3, griffin_lim_momentum=0.99)
    cfg = dsp.DSPConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(dsp.DSPConfig)})
    S = np.clip(fft_mag, 0.0, 1.0)
    want = np.asarray(jdsp.inv_spectrogram(jnp.asarray(S), jcfg))
    got = dsp.inv_spectrogram(torch.from_numpy(S), cfg).numpy()
    assert _rel(got, want) < 1e-4


def test_vocoder_takes_the_fft_route_when_hop_does_not_divide_n_fft(fft_mag, monkeypatch):
    """``inference._gl_vocode`` as JAX ``inference.py:79-91``."""
    calls = []
    for name, mod in (("fft", dsp), ("auto", stft_matmul)):
        fn = getattr(mod, "griffin_lim" if name == "fft" else "griffin_lim_auto")
        monkeypatch.setattr(mod, fn.__name__,
                            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    cfg = dsp.DSPConfig(22050, FFT_N, FFT_HOP, 80, 0.0, None, 0.97, -100.0, 20.0, 1.5, 2)
    lin = torch.from_numpy(np.clip(fft_mag, 0.0, 1.0))
    wav = inference._gl_vocode(lin, None, cfg, False)
    assert calls == ["fft"] and wav.shape == (2, FFT_HOP * 19)
    cfg = dsp.DSPConfig(22050, 1024, 256, 80, 0.0, None, 0.97, -100.0, 20.0, 1.5, 2)
    inference._gl_vocode(torch.rand(2, 20, 513, generator=torch.Generator().manual_seed(0)),
                         None, cfg, False)
    assert calls == ["fft", "auto"]


# -- the persistent kernel's decomposition (csrc/griffin_lim.cu) ---------------
def test_inverse_leaves_are_scaled_transposes_of_the_forward_leaves():
    """The kernel keeps only the bf16 forward leaves: the inverse leaf of
    class c is (two / 128) times the transposed conjugate, two = 2 for the
    mirrored classes 1-3, and that holds exactly after the bf16 rounding."""
    ops = staged._operands(torch.device("cpu"), torch.bfloat16)
    for g, c in enumerate(staged.KEPT):
        (Mr, Mi), (IMr, IMi) = ops["fwd"][g], ops["inv"][g]
        s = (2.0 if c in (1, 2, 3) else 1.0) / staged.L
        assert torch.equal(IMr, s * Mr.t()) and torch.equal(IMi, -s * Mi.t())
        assert torch.equal(ops["leaves"][g, 0].float(), Mr)
        assert torch.equal(ops["leaves"][g, 1].float(), Mi)
    assert ops["leaves"].shape == (5, 2, 128, 128) and ops["leaves"].dtype == torch.bfloat16


def _kernel_order(mag_staged, hop, n_iter, compute_dtype, momentum=0.0):
    """The iteration as ``csrc/griffin_lim.cu`` decomposes it: per class the
    forward products from the forward leaves (complex classes as four real
    products), the projection, and the inverse products from the same
    leaves transposed and scaled; per leaf position m the inverse butterfly,
    the overlap-add over frames padded by a K - 1 halo, the re-framing and
    the forward butterfly into the kernel's z planes (z0, z4, z1r, z1i, z2r,
    z2i, z3r, z3i) and u planes (u0, u1r, u1i, u2r, u2i, u3r, u3i, u4)."""
    B, T, _ = mag_staged.shape
    K, L = N_FFT // hop, staged.L
    per_row, halo = hop // L, K - 1
    ops = staged._operands(mag_staged.device, compute_dtype)
    M = [ops["fwd"][c] for c in range(5)]
    wsum = staged._wsum_rows(hop, T, mag_staged.device).reshape(T + K - 1, per_row, L)
    mag = mag_staged.float()

    def rnd(x):
        return x.to(compute_dtype).float()

    def u_planes(Y):  # Y[c] = (Yr, Yi), (B, T, 128) each
        planes = [None] * 8
        for c, (Yr, Yi) in enumerate(Y):
            s = (2.0 if c in (1, 2, 3) else 1.0) / L
            Mr, Mi = M[c]
            ur = (rnd(Yr) @ Mr.t() + rnd(Yi) @ Mi.t()) * s
            ui = (rnd(Yi) @ Mr.t() - rnd(Yr) @ Mi.t()) * s
            if c in (0, 4):
                planes[0 if c == 0 else 7] = ur
            else:
                planes[2 * c - 1], planes[2 * c] = ur, ui
        return torch.stack(planes, dim=2)

    def signal_rows(u):
        u0, Ur1, Ui1, Ur2, Ui2, Ur3, Ui3, u4 = u.unbind(2)
        blocks = staged._combine_inverse([(u0, None), (Ur1, Ui1), (Ur2, Ui2), (Ur3, Ui3),
                                          (u4, None)])
        frames = torch.stack([blocks[j] * ops["syn"][j] for j in range(8)], dim=2)
        pad = frames.new_zeros((B, halo, 8, L))
        fp = torch.cat([pad, frames, pad], dim=1)
        rows = frames.new_zeros((B, T + K - 1, per_row, L))
        for q in range(K):
            rows = rows + fp[:, halo - q:halo - q + T + K - 1, q * per_row:(q + 1) * per_row]
        return rows * wsum

    def z_planes(rows):
        b = [rows[:, j // per_row:j // per_row + T, j % per_row] * ops["win"][j]
             for j in range(8)]
        (z0, _), (z1r, z1i), (z2r, z2i), (z3r, z3i), (z4, _) = staged._combine_forward(b)
        return [rnd(p) for p in (z0, z4, z1r, z1i, z2r, z2i, z3r, z3i)]

    def spectra(z):
        z0, z4, z1r, z1i, z2r, z2i, z3r, z3i = z
        X = [(z0 @ M[0][0], z0 @ M[0][1])]
        for zr, zi, (Mr, Mi) in ((z1r, z1i, M[1]), (z2r, z2i, M[2]), (z3r, z3i, M[3])):
            X.append((zr @ Mr + (-zi) @ Mi, zr @ Mi + zi @ Mr))
        X.append((z4 @ M[4][0], z4 @ M[4][1]))
        return X

    beta = momentum / (1.0 + momentum)
    P = [(torch.zeros_like(mag[..., :L]),) * 2 for _ in range(5)]
    u = u_planes([(mag[..., c * L:(c + 1) * L], torch.zeros_like(mag[..., :L]))
                  for c in range(5)])
    for _ in range(n_iter):
        X = spectra(z_planes(signal_rows(u)))
        Y = []
        for c, (xr, xi) in enumerate(X):
            if momentum > 0.0:
                (pr, pi), P[c] = P[c], (rnd(xr), rnd(xi))
                xr, xi = xr - beta * pr, xi - beta * pi
            m = mag[..., c * L:(c + 1) * L]
            sc = m * torch.rsqrt(xr * xr + xi * xi + 1e-12)
            Y.append((xr * sc, xi * sc))
        u = u_planes(Y)
    rows = signal_rows(u)[:, K // 2:K // 2 + T - 1]
    return rows.reshape(B, (T - 1) * hop)


@pytest.mark.parametrize("hop", [128, 256, 512])
@pytest.mark.parametrize("momentum", [0.0, 0.99])
def test_kernel_decomposition_matches_the_plain_version_f32(mag, hop, momentum):
    """In f32 the kernel's decomposition is the plain version's map with
    sums in another order: within 1e-4 of the peak after three iterations,
    at every hop the kernel takes, with and without momentum."""
    ms = staged.staged_magnitudes(torch.from_numpy(mag), torch.float32)
    want = staged.griffin_lim_staged_plain(ms, hop, 3, torch.float32, momentum)
    got = _kernel_order(ms, hop, 3, torch.float32, momentum)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want.numpy()) < 1e-4


def test_kernel_decomposition_tracks_pallas_interpret_bf16(mag):
    """With bf16 operands the decomposition tracks the TPU kernel (interpret
    mode) as the plain version does: below 1% of the peak at three
    iterations."""
    want = np.asarray(jax_staged(jnp.asarray(mag), N_FFT, HOP, 3, interpret=True))
    ms = staged.staged_magnitudes(torch.from_numpy(mag), torch.bfloat16)
    assert _rel(_kernel_order(ms, HOP, 3, torch.bfloat16).numpy(), want) < 1e-2


@pytest.mark.parametrize("shape, hop, match", [
    ((4, 128, 640), 256, None),
    ((1, 2, 640), 128, None),
    ((2, 47, 640), 512, None),
    ((4, 128, 513), 256, "staged magnitudes"),
    ((4, 1, 640), 256, "staged magnitudes"),
    ((0, 8, 640), 256, "staged magnitudes"),
    ((4, 128, 640), 384, "hop in"),
    ((4, 128, 640), 1024, "hop in"),
])
def test_staged_kernel_shape_rule(shape, hop, match):
    reason = staged.staged_shape_reason(shape, hop)
    assert reason is None if match is None else match in reason


def test_staged_kernel_refuses_cpu_tensors():
    before = (staged.KERNEL.launches, staged.MOM_KERNEL.launches)
    with pytest.raises(ValueError, match="CUDA"):
        staged.griffin_lim_staged_kernel(torch.zeros(1, 4, 640, dtype=torch.bfloat16), 256, 2)
    assert (staged.KERNEL.launches, staged.MOM_KERNEL.launches) == before
