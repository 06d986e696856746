"""The dense Griffin-Lim kernel's plain version against the JAX package's
``griffin_lim_pallas`` in interpret mode, on the same seeded magnitudes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.audio import oracle
from multi_speaker_tts_tpu.ops import griffin_lim_kernel as jgk
from multi_speaker_tts_tpu_torch.ops import griffin_lim_kernel as gk

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

SHAPES = [(256, 64, 33), (512, 128, 20)]  # n_fft, hop, T


def _mag(n_fft, T, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((2, T, n_fft // 2 + 1)) ** 2).astype(np.float32)


def _rel(a, b, peak=None):
    return np.abs(a - b).max() / max(np.abs(b if peak is None else peak).max(), 1e-9)


def _jax(mag, n_fft, hop, n_iter, dtype, momentum):
    return np.asarray(jgk.griffin_lim_pallas(jnp.asarray(mag), n_fft, hop, n_iter,
                                             interpret=True, compute_dtype=dtype,
                                             momentum=momentum))


@pytest.mark.parametrize("n_fft, hop", [(256, 64), (512, 128), (1024, 256)])
def test_operands_bit_equal_to_jax(n_fft, hop):
    want = jgk._gl_operands(n_fft, hop, "float32")
    got = gk._gl_operands(n_fft, hop)
    assert got[-1] == want[-1]
    for a, b in zip(got[:-1], want[:-1]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    T = 20
    rows_pad = jgk._round_up(T + n_fft // hop - 1, 8)
    np.testing.assert_array_equal(gk._wsum_rows(n_fft, hop, T, rows_pad),
                                  jgk._wsum_rows(n_fft, hop, T, rows_pad))


@pytest.mark.parametrize("momentum", [0.0, 0.99])
@pytest.mark.parametrize("n_fft, hop, T", SHAPES)
def test_plain_matches_pallas_interpret_f32(n_fft, hop, T, momentum):
    """The same iteration, f32 products on both sides: agreement to f32
    summation order."""
    mag = _mag(n_fft, T)
    want = _jax(mag, n_fft, hop, 4, "float32", momentum)
    got = gk.griffin_lim_dense(torch.from_numpy(mag), n_fft, hop, 4,
                               compute_dtype=torch.float32, momentum=momentum).numpy()
    assert got.shape == want.shape == (2, hop * (T - 1))
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("momentum", [0.0, 0.99])
@pytest.mark.parametrize("n_fft, hop, T", SHAPES)
def test_plain_bf16_tracks_pallas_interpret_bf16(n_fft, hop, T, momentum):
    """bf16 matrices and operands on both sides: operand roundings flip
    where the two f32 sums differ in their last bit; within 5% of the f32
    result's peak (the JAX package's own bf16 quality gate)."""
    mag = _mag(n_fft, T, seed=1)
    want = _jax(mag, n_fft, hop, 4, "bfloat16", momentum)
    peak = _jax(mag, n_fft, hop, 4, "float32", momentum)
    got = gk.griffin_lim_dense(torch.from_numpy(mag), n_fft, hop, 4,
                               momentum=momentum).numpy()
    assert _rel(got, want, peak) <= 5e-2


def test_reconstructs_nyquist_energy():
    """The port of the JAX package's ``test_gl_kernel_reconstructs_nyquist_energy``:
    all the energy in the Nyquist bin, which rides outside the products."""
    n_fft, hop, T = 256, 64, 33
    mag = np.full((1, T, n_fft // 2 + 1), 1e-3, np.float32)
    mag[..., -1] = 1.0
    y = gk.griffin_lim_dense(torch.from_numpy(mag), n_fft, hop, 8,
                             compute_dtype=torch.float32).numpy()[0]
    rec = np.abs(oracle.stft(y, n_fft, hop))[:T - 2]
    assert rec[2:, -1].mean() > 0.5, rec[2:, -1].mean()
    assert rec[2:, -1].mean() > 10 * rec[2:, :-1].mean()


def test_momentum_converges_tighter():
    """Accelerated Griffin-Lim reaches better spectral consistency at the
    same iteration count (the JAX package's ``test_momentum_gl_converges_tighter``)."""
    n_fft, hop, T = 256, 64, 33
    t = np.arange(hop * (T - 1)) / 16000.0
    wav = (np.sin(2 * np.pi * 220 * t) + 0.5 * np.sin(2 * np.pi * 1330 * t)) * np.hanning(t.size)
    mag = np.abs(oracle.stft(wav.astype(np.float32), n_fft, hop))[None, :T].astype(np.float32)

    def consistency(y):
        rec = np.abs(oracle.stft(y, n_fft, hop))[:T]
        return np.abs(rec - mag[0]).mean() / np.abs(mag[0]).mean()

    plain, fast = (consistency(gk.griffin_lim_dense(torch.from_numpy(mag), n_fft, hop, 12,
                                                    compute_dtype=torch.float32,
                                                    momentum=m).numpy()[0])
                   for m in (0.0, 0.99))
    assert fast < plain, (fast, plain)


def test_odd_ratio_raises():
    with pytest.raises(ValueError, match="even"):
        gk.griffin_lim_dense(torch.zeros(1, 8, 97), 192, 64, 2)
    with pytest.raises(ValueError, match="bins"):
        gk.griffin_lim_dense(torch.zeros(1, 8, 100), 256, 64, 2)


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    mag = torch.from_numpy(_mag(256, 9))
    before = gk.KERNEL.launches
    gk.griffin_lim_dense(mag, 256, 64, 1)
    assert gk.KERNEL.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        gk.griffin_lim_dense_kernel(*gk.split_magnitude(mag, 256), 256, 64, 1)
    assert gk.KERNEL.launches == before


# The kernel's host-side layout: its packed matrices, and the planner that
# ops/griffin_lim_kernel.py mirrors from csrc/griffin_lim_dense.cu.
PACK_SHAPES = [(256, 128), (512, 128), (768, 128), (1024, 256), (1024, 512), (2048, 256),
               (2048, 1024)]


@pytest.mark.parametrize("n_fft, hop", PACK_SHAPES)
def test_packed_matrices_unpack_to_the_plain_layout(n_fft, hop):
    """Every synthesis column lands once in one inverse slice (pad columns
    zero), every [Wr | Wi] column once in one forward group, and the core
    matrices hold them exactly."""
    ops, _ = gk._operands(n_fft, hop, torch.device("cpu"), torch.bfloat16)
    cols = gk.inverse_columns(n_fft, hop)
    assert sorted(cols[cols >= 0].tolist()) == list(range(n_fft))
    fcols = gk.forward_columns(n_fft)
    assert sorted(fcols.ravel().tolist()) == list(range(n_fft))
    # Group g, pair p: Wr then Wi of the same eight bins.
    assert (fcols[:, 8:16] == fcols[:, 0:8] + n_fft // 2).all()

    def unpack(packed):  # (..., 8, K / 8, 8, 8) -> (..., 64, K)
        *lead, nb, kc, r, e = packed.shape
        return packed.transpose(-3, -2).reshape(*lead, nb * r, kc * e)

    vp = unpack(gk.pack_inverse(ops["vcat"], n_fft, hop))
    for s in range(cols.shape[0]):
        live = cols[s] >= 0
        assert torch.equal(vp[s, torch.from_numpy(live)], ops["vcat"].t()[cols[s][live]])
        assert not vp[s, torch.from_numpy(~live)].any()
    wp = unpack(gk.pack_forward(ops["wcat"], n_fft))
    assert torch.equal(wp.reshape(-1, n_fft), ops["wcat"].t()[fcols.ravel()])


def test_dense_plan_of_the_source_note():
    """B 4, T 128, n_fft 1024, hop 256 on an H100: 16 column slices of 16
    hop-columns resident in shared memory, 8 blocks each, inverse units of
    66 rows (69 frames), forward units of 64 frames."""
    p = gk.dense_plan(4, 128, 1024, 256)
    assert (p["k"], p["cs"], p["n_cs"], p["n_bs"], p["nr"]) == (4, 16, 16, 16, 131)
    assert (p["resident"], p["blocks"], p["rt"], p["m_out"], p["ft"], p["mf"]) == (1, 128, 2, 66, 2, 64)
    assert p["smem"] <= gk.H100_SMEM
    assert p["scratch"] == gk.dense_scratch_bytes(4, 128, 1024, 256, False)
    # The wider transforms stream their slices; the momentum carries add scratch.
    assert gk.dense_plan(4, 128, 2048, 256)["resident"] == 0
    assert gk.dense_plan(4, 128, 1024, 256, True)["scratch"] > p["scratch"]


@pytest.mark.parametrize("B, T", [(1, 2), (2, 17), (3, 47), (4, 128), (32, 128), (1, 1000)])
@pytest.mark.parametrize("n_fft, hop", PACK_SHAPES)
def test_dense_plan_covers_every_row_and_frame(B, T, n_fft, hop):
    """Whatever the shape, the tiles cover every signal row and frame, fit
    the block's shared memory and the card's SMs, and every block serves
    one column slice."""
    p = gk.dense_plan(B, T, n_fft, hop)
    k = n_fft // hop
    assert p["rt"] * p["m_out"] >= T + k - 1 > (p["rt"] - 1) * p["m_out"]
    assert p["m_out"] + k - 1 <= gk.MAX_M
    assert p["ft"] * p["mf"] >= T > (p["ft"] - 1) * p["mf"]
    assert p["mf"] <= gk.MAX_F
    assert p["blocks"] % p["n_cs"] == 0 and p["n_cs"] <= p["blocks"] <= gk.H100_SMS
    assert p["smem"] <= gk.H100_SMEM
    assert p["k"] * p["cs"] <= gk.TILE_N and hop % p["cs"] == 0
