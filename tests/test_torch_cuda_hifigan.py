"""The HiFi-GAN MRF kernels (``csrc/hifigan_mrf.cu``) against their plain
versions, and the generator on its kernel route, on the card.

Marked ``cuda``: they need an sm_90a card and ``nvcc`` and skip without
them. On the card: ``python -m pytest -m cuda tests/test_torch_cuda_hifigan.py``.

Tolerances. One launch sums the same bf16 products in f32 as its plain
version (an f32 convolution of the rounded operands, TF32 off), in another
order (:func:`_sum_gap`), and a bf16 output can land one bf16 step apart
where the two sums straddle a rounding boundary, which few do (0.04% of
conv 1's outputs at 256 channels).
"""

import time

import numpy as np
import pytest
import torch

import reference_hifigan as ref
from multi_speaker_tts_tpu_torch import telemetry
from multi_speaker_tts_tpu_torch.hparams import default_hparams
from multi_speaker_tts_tpu_torch.models.hifigan import V1, HiFiGAN
from multi_speaker_tts_tpu_torch.ops import hifigan_mrf

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda
N_MELS = 80
V1_SHAPES = [(C, k, d) for C in (256, 128, 64, 32) for k in (3, 7, 11) for d in (1, 3, 5)]
# The cell's largest bucket (400 frames, B 32): each stage's (C, L).
BUCKET = {256: 3200, 128: 25600, 64: 51200, 32: 102400}


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


def _operands(C, k, B, L, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((B, L, C), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((C, C, k), generator=g, device=dev) / (C * k) ** 0.5).to(torch.bfloat16)
    bias = (torch.rand((C,), generator=g, device=dev) - 0.5).to(torch.bfloat16)
    xin = torch.randn((B, L, C), generator=g, device=dev)
    acc = torch.randn((B, L, C), generator=g, device=dev)
    return a, w, bias, xin, acc


def _sum_gap(C, k, scale):
    """How far two f32 sums of the same C k products, taken in other orders,
    may lie apart: 16 f32 ulps times sqrt(C k) (the rounding of partial
    sums of about the outputs' size, ``scale``, walks like a random sum;
    16 covers the largest of a few million outputs)."""
    return 16 * 2.0 ** -24 * (C * k) ** 0.5 * max(scale, 1.0)


def _close_f32(got, want, C, k):
    scale = float(want.pow(2).mean().sqrt())
    assert float((got - want).abs().max()) <= _sum_gap(C, k, scale)


def _bf16_step(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


def _close_bf16(got, want, C, k):
    """One bf16 step apart at most, beyond the sums' own gap (a small output
    is a sum of larger products, so their gap can span several of its
    steps); few outputs differ at all."""
    got, want = got.float(), want.float()
    gap = (got - want).abs()
    tol = _bf16_step(torch.maximum(got.abs(), want.abs())) + _sum_gap(C, k, 1.0)
    assert bool((gap <= tol).all()), float(gap.max())
    assert float((gap > 0).float().mean()) < 0.01


def _both(C, k, d, B, L, dev, seed):
    """Conv 1 and the mean-writing conv 2 epilogue through the kernel (twice)
    and the plain version."""
    a, w, bias, xin, acc = _operands(C, k, B, L, dev, seed)
    outs = []
    for run in (hifigan_mrf.conv_kernel, hifigan_mrf.conv_kernel, hifigan_mrf.conv_plain):
        h = torch.empty_like(a)
        run(a, w, bias, d, act=h, slope=0.1)
        x = acc.clone()
        act = torch.empty_like(a)
        run(a, w, bias, d, xin=xin, acc=x, xout=x, act=act, slope=0.01, div=3.0)
        outs.append((h, x, act))
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("C,k,d", V1_SHAPES)
def test_mrf_conv_matches_plain_at_a_ragged_length(dev, C, k, d):
    tm = hifigan_mrf.plan(C, k, d, 1, 1).tm
    L = 2 * tm + 37  # a ragged last tile, and a halo past both ends
    before = hifigan_mrf.KERNEL.launches
    (h, x, act), (h2, x2, act2), (hp, xp, actp) = _both(C, k, d, 3, L, dev, C + k + d)
    assert hifigan_mrf.KERNEL.launches == before + 4
    assert torch.equal(h, h2) and torch.equal(x, x2) and torch.equal(act, act2)
    _close_bf16(h, hp, C, k)
    _close_f32(x, xp, C, k)
    _close_bf16(act, actp, C, k)


@pytest.mark.parametrize("C,k,d", V1_SHAPES)
def test_mrf_conv_matches_plain_at_the_largest_bucket(dev, C, k, d):
    """Each stage's width at the cell's 400-frame bucket, B 32."""
    (h, x, act), (h2, x2, act2), (hp, xp, actp) = _both(C, k, d, 32, BUCKET[C], dev, k + d)
    assert torch.equal(h, h2) and torch.equal(x, x2) and torch.equal(act, act2)
    _close_bf16(h, hp, C, k)
    _close_f32(x, xp, C, k)
    _close_bf16(act, actp, C, k)


def test_mrf_in_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    y = torch.randn((5, 77, 64), generator=g, device=dev).to(torch.bfloat16)
    bias = torch.randn((64,), generator=g, device=dev).to(torch.bfloat16)
    before = hifigan_mrf.IN_KERNEL.launches
    x0 = hifigan_mrf.mrf_in(y, bias)
    assert hifigan_mrf.IN_KERNEL.launches == before + 1
    assert torch.equal(x0, y.float() + bias.float())


@pytest.mark.parametrize("C", sorted(BUCKET))
@pytest.mark.parametrize("slope", [0.1, 0.01])
def test_activation_matches_plain(dev, C, slope):
    """The activation pass at the cell's largest bucket and at a short,
    ragged one (fewer elements than a block's threads take): bit-equal to
    lrelu then one rounding."""
    g = torch.Generator(device=dev).manual_seed(C)
    for B, L in ((32, BUCKET[C]), (3, 77)):
        x = torch.randn((B, L, C), generator=g, device=dev) * 4
        a = hifigan_mrf.activation(x, slope)
        assert torch.equal(a, torch.nn.functional.leaky_relu(x, slope).to(torch.bfloat16))


def _generator(dev, dtype, seed=0, cfg=V1):
    hp = default_hparams().replace(Vocoder={"Type": "HiFiGAN", "HiFiGAN": cfg})
    W = ref.seeded_weights(cfg, N_MELS, seed)
    gen = HiFiGAN.from_hp(hp, dtype).load({k: v.numpy() for k, v in W.items()})
    return gen.to(dev), {k: v.to(dev) for k, v in W.items()}


def _mel(dev, rows=3, frames=23, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((rows, frames, N_MELS), generator=g).to(dev)


def _rel(a, b):
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def test_generator_runs_the_kernels_and_is_its_own_stages(dev, capsys):
    """bf16 V1 on the card: the MRFs through the kernels (launches, the
    telemetry count, no ``[dispatch]`` line); ``forward`` bit-equal to
    ``post(stage(3, ... stage(0, pre(mel))))`` and to itself; each stage a
    (B, C, L) view whose rows match the f32 reference's stage on the same
    input; the waveform within the bf16 tolerance of the CPU tests."""
    from torch.profiler import ProfilerActivity, profile

    gen, W = _generator(dev, torch.bfloat16)
    mel = _mel(dev)
    before, before_in = hifigan_mrf.KERNEL.launches, hifigan_mrf.IN_KERNEL.launches
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        lo = time.time_ns()
        out = gen(mel)
        torch.cuda.synchronize()
        hi = time.time_ns()
    steps = telemetry.events("vocode.mrf_kernel_steps", lo, hi)
    assert sum(n for _, n in steps) == 4 * 9 * mel.shape[0]  # 4 stages x 3 blocks x 3 dilations
    assert hifigan_mrf.KERNEL.launches == before + 4 * 9 * 2
    # each stage: its input's activation, mrf_in, the MRF's activation; post's
    assert hifigan_mrf.IN_KERNEL.launches == before_in + 4 * 3 + 1
    assert "[dispatch] hifigan_mrf" not in capsys.readouterr().out
    with torch.no_grad():
        again = gen(mel)
        acts = [gen.pre(mel)]
        for i in range(4):
            acts.append(gen.stage(i, acts[-1]))
        staged = gen.post(acts[-1])
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        assert torch.equal(out, staged)
        cfg = V1
        for i in range(4):
            x = acts[i + 1]
            assert x.dtype == torch.float32 and x.transpose(1, 2).is_contiguous()
            want = _ref_stage(W, i, acts[i], cfg)
            per_frame = int(np.prod(cfg["Upsample_Rates"][:i + 1]))
            for j, frames in enumerate((23, 11, 5)):
                span = frames * per_frame
                assert _rel(x[j, ..., :span], want[j, ..., :span]) <= 1e-2
        want = ref.generate(W, mel, cfg)
    assert _rel(out, want) <= 1.5e-2


def _ref_stage(W, i, x, cfg):
    """``reference_hifigan.generate``'s stage i, f32, on ``x``."""
    import torch.nn.functional as F

    u, k = cfg["Upsample_Rates"][i], cfg["Upsample_Kernel_Sizes"][i]
    ks, dils = cfg["Resblock_Kernel_Sizes"], cfg["Resblock_Dilation_Sizes"]
    x = F.conv_transpose1d(F.leaky_relu(x, 0.1), W[f"ups.{i}.weight"], W[f"ups.{i}.bias"],
                           stride=u, padding=(k - u) // 2)
    outs = []
    for j, (kk, dil) in enumerate(zip(ks, dils)):
        y = x
        for m, d in enumerate(dil):
            name = f"resblocks.{i * len(ks) + j}"
            c1, c2 = f"{name}.convs1.{m}", f"{name}.convs2.{m}"
            yt = F.conv1d(F.leaky_relu(y, 0.1), W[c1 + ".weight"], W[c1 + ".bias"],
                          dilation=d, padding=d * (kk - 1) // 2)
            y = y + F.conv1d(F.leaky_relu(yt, 0.1), W[c2 + ".weight"], W[c2 + ".bias"],
                             padding=(kk - 1) // 2)
        outs.append(y)
    return sum(outs) / len(outs)


def test_f32_and_unbuilt_widths_run_plain_on_the_card(dev, capsys):
    """f32 runs the plain path on the card with one ``[dispatch]`` line; a
    bf16 generator at a width the kernels were not built for is refused,
    not run plain."""
    before = hifigan_mrf.KERNEL.launches
    gen, W = _generator(dev, torch.float32)
    mel = _mel(dev, rows=2, frames=7)
    with torch.no_grad():
        out = gen(mel)
        want = ref.generate(W, mel, V1)
    assert float((out - want).abs().max()) <= 1e-4  # f32, TF32 off
    torch.cuda.synchronize()
    assert hifigan_mrf.KERNEL.launches == before
    assert "[dispatch] hifigan_mrf -> plain" in capsys.readouterr().out
    small, _ = _generator(dev, torch.bfloat16, cfg=dict(V1, Upsample_Initial_Channel=32))
    with torch.no_grad(), pytest.raises(ValueError, match="the MRF kernel is built for"):
        small(mel)
    assert hifigan_mrf.KERNEL.launches == before
