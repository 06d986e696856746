"""The HiFi-GAN MRF kernels' Python side (``ops/hifigan_mrf.py``) on the CPU:
the route, the launch plans at H100 constants, the channels-last sequence
of launches with the plain convolution in place of the kernel (against
the generator's plain MRF and ``tests/reference_hifigan.py``), and the
generator run on its kernel route's layout (channels-last stages, each
activation computed where it is read) with plain convolutions.
The kernels themselves run in ``tests/test_torch_cuda_hifigan.py`` on the
card."""

import pytest
import torch
import torch.nn.functional as F

import reference_hifigan as ref
from multi_speaker_tts_tpu_torch.hparams import default_hparams
from multi_speaker_tts_tpu_torch.models.hifigan import SLOPE, V1, HiFiGAN
from multi_speaker_tts_tpu_torch.ops import _build, hifigan_mrf

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

N_MELS = 80
WIDTHS = (256, 128, 64, 32)  # V1's four stages
V1_SHAPES = tuple((C, k, d) for C in WIDTHS for k in (3, 7, 11) for d in (1, 3, 5))
F32_TOL = 1e-5  # tests/test_torch_hifigan.py's
BF16_REL = 1.5e-2


def _hp(cfg):
    return default_hparams().replace(Vocoder={"Type": "HiFiGAN", "HiFiGAN": cfg})


def _generator(cfg, dtype=torch.float32, seed=0):
    W = ref.seeded_weights(cfg, N_MELS, seed)
    return HiFiGAN.from_hp(_hp(cfg), dtype).load({k: v.numpy() for k, v in W.items()}), W


def _rel(a, b):
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


# -- route ---------------------------------------------------------------------

@pytest.mark.parametrize("on_card,dtype,shapes,chosen,why", [
    (True, torch.bfloat16, V1_SHAPES, "kernel", None),
    (False, torch.bfloat16, V1_SHAPES, "plain", None),
    (True, torch.float32, V1_SHAPES, "plain", "compute dtype"),
    (True, torch.bfloat16, ((16, 3, 1),), "refused", "16 channels"),
    (True, torch.bfloat16, ((48, 3, 1),), "refused", "48 channels"),
    (True, torch.bfloat16, ((512, 3, 1),), "refused", "512 channels"),
    (True, torch.bfloat16, ((64, 4, 1),), "refused", "odd kernels"),
    (True, torch.bfloat16, ((256, 11, 40),), "refused", "shared memory"),
])
def test_route(on_card, dtype, shapes, chosen, why):
    """bf16 on the card launches; a CPU tensor and f32 run plain (f32 with
    its reason); bf16 on the card at a convolution the kernel was not built
    for is refused with the reason, not run plain."""
    if chosen == "refused":
        with pytest.raises(ValueError, match=why):
            hifigan_mrf.route(on_card, dtype, shapes)
        return
    got, reason = hifigan_mrf.route(on_card, dtype, shapes)
    assert got == chosen
    assert (reason is None) if why is None else (why in reason)


def test_tiles_are_the_kernels_instantiations():
    """TILES is read from the source's ``using TileN = Tile<...>`` lines:
    one a V1 width, each (warps along L, warps along C, warp rows, warp
    columns, chunk, ring depth), eight warps a block."""
    assert sorted(hifigan_mrf.TILES) == sorted(WIDTHS)
    for C, (wm, wn, rows, cols, chunk, stages) in hifigan_mrf.TILES.items():
        assert wm * wn == 8 and C % (wn * cols) == 0 and C % chunk == 0 and stages == 3


def test_a_cpu_tensor_runs_plain_without_a_dispatch_line(capsys):
    assert not hifigan_mrf.use_kernel(torch.zeros(1), torch.bfloat16, V1_SHAPES)
    assert "[dispatch]" not in capsys.readouterr().out


@pytest.mark.parametrize("C,tiles,chunk", [(256, (128, 256), 64), (128, (128, 128), 64),
                                           (64, (256, 64), 64), (32, (512, 32), 32)])
@pytest.mark.parametrize("k,d", [(3, 1), (7, 3), (11, 5)])
def test_plan_at_h100_constants(C, tiles, chunk, k, d):
    """Tiles of each V1 width, the slab of (tm + (k - 1) d) rows, a
    three-deep weight ring, shared memory within an H100 block, and a grid
    that covers (B, L) once: the cell's largest bucket and a ragged length."""
    tm, tn = tiles
    for L, B in ((3200 * 256 // C, 32), (2 * tm + 37, 3), (1, 1)):
        p = hifigan_mrf.plan(C, k, d, L, B)
        assert (p.tm, p.tn, p.rows) == (tm, tn, tm + (k - 1) * d)
        assert p.smem == 2 * (p.rows * (C + 8) + 3 * tn * (chunk + 8))
        assert p.smem <= _build.H100[1]
        assert p.grid == (-(-L // tm), C // tn, B)
        assert (p.grid[0] - 1) * tm < L <= p.grid[0] * tm
    # Blocks an SM by shared memory: at least the build's launch bound.
    per_sm = {256: 1, 128: 2, 64: 2, 32: 2}[C]
    assert per_sm * hifigan_mrf.plan(C, 11, 5, 1, 1).smem <= 228 * 1024


# -- the plain launch ----------------------------------------------------------

def _operands(C, k, B=2, L=19, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((B, L, C), generator=g).to(dtype)
    w = (torch.randn((C, C, k), generator=g) / (C * k) ** 0.5).to(dtype)
    bias = (torch.rand((C,), generator=g) - 0.5).to(dtype)
    return a, w, bias, torch.randn((B, L, C), generator=g), torch.randn((B, L, C), generator=g)


@pytest.mark.parametrize("C", WIDTHS)
def test_conv_plain_epilogues(C):
    """Conv 1 writes lrelu(conv + bias) in act's dtype; conv 2 adds the
    residual, then the running sum, divides, and writes in place."""
    a, w, bias, xin, acc = _operands(C, 7, dtype=torch.bfloat16)
    v = F.conv1d(a.transpose(1, 2).float(), w.float(), bias.float(), dilation=3,
                 padding=9).transpose(1, 2)
    h = torch.empty_like(a)
    hifigan_mrf.conv_plain(a, w, bias, 3, act=h)
    assert torch.equal(h, F.leaky_relu(v, SLOPE).to(torch.bfloat16))
    x = acc.clone()
    act = torch.empty_like(a)
    hifigan_mrf.conv_plain(a, w, bias, 3, xin=xin, acc=x, xout=x, act=act, slope=0.01, div=3)
    want = (acc + (xin + v)) / 3
    assert torch.equal(x, want)
    assert torch.equal(act, F.leaky_relu(want, 0.01).to(torch.bfloat16))


def test_mrf_in_plain_adds_the_bias_in_f32():
    y = torch.randn((2, 5, 64)).to(torch.bfloat16)
    bias = torch.randn(64).to(torch.bfloat16)
    x0 = hifigan_mrf.mrf_in(y, bias)
    assert x0.dtype == torch.float32 and torch.equal(x0, y.float() + bias.float())


@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("slope", [SLOPE, 0.01])
def test_activation_is_lrelu_rounded_once(C, slope):
    """The activation pass keeps (B, L, C) and rounds the f32 LeakyReLU
    once, as the plain path's ``leaky_relu(x).to(dtype)``."""
    x = torch.randn((2, 7, C), generator=torch.Generator().manual_seed(C))
    a = hifigan_mrf.activation(x, slope)
    assert a.dtype == torch.bfloat16 and a.shape == x.shape
    assert torch.equal(a, F.leaky_relu(x, slope).to(torch.bfloat16))
    assert torch.equal(hifigan_mrf.activation(x, slope, torch.float32), F.leaky_relu(x, slope))


# -- the channels-last MRF against the plain MRF and the reference --------------

@torch.no_grad()
def _stage_input(gen, i, frames=6, rows=2, seed=3):
    """A plausible stage-i MRF input: the transposed convolution's output on
    noise, f32 (B, C, L)."""
    g = torch.Generator().manual_seed(seed)
    C_in = gen.ups[i].weight.shape[0]
    x = torch.randn((rows, C_in, frames), generator=g)
    u, k = gen.rates[i], gen.kernel_sizes[i]
    return F.conv_transpose1d(F.leaky_relu(x, SLOPE), gen.ups[i].weight.float(),
                              gen.ups[i].bias.float(), stride=u, padding=(k - u) // 2)


@pytest.mark.parametrize("i", range(4))
def test_channels_last_mrf_is_the_plain_mrf_in_f32(i):
    """At each V1 width the sequence of launches, run with the plain
    convolution in f32, gives the generator's plain MRF bit for bit."""
    gen, _ = _generator(V1)
    x = _stage_input(gen, i)
    blocks = gen.resblocks[3 * i:3 * i + 3]
    with torch.no_grad():
        want = gen.mrf(i, x)
        out = hifigan_mrf.mrf(blocks, x.transpose(1, 2).contiguous())
    assert torch.equal(out.transpose(1, 2), want)


@pytest.mark.parametrize("i", range(4))
def test_channels_last_mrf_in_bf16_within_its_rounding(i):
    """bf16 at each V1 width against the f32 reference MRF on the same input:
    the kernels' arithmetic (one rounding a convolution operand)."""
    gen, W = _generator(V1, torch.bfloat16)
    x = _stage_input(gen, i)
    blocks = gen.resblocks[3 * i:3 * i + 3]
    with torch.no_grad():
        out = hifigan_mrf.mrf(blocks, x.transpose(1, 2).contiguous())
    want = sum(_ref_block(W, 3 * i + j, x, k) for j, k in enumerate((3, 7, 11))) / 3
    assert 0.0 < _rel(out.transpose(1, 2), want) <= BF16_REL
    assert out.dtype == torch.float32


def _ref_block(W, j, x, k):
    for m, d in enumerate((1, 3, 5)):
        c1, c2 = f"resblocks.{j}.convs1.{m}", f"resblocks.{j}.convs2.{m}"
        xt = F.conv1d(F.leaky_relu(x, SLOPE), W[c1 + ".weight"], W[c1 + ".bias"], dilation=d,
                      padding=d * (k - 1) // 2)
        x = x + F.conv1d(F.leaky_relu(xt, SLOPE), W[c2 + ".weight"], W[c2 + ".bias"],
                         padding=(k - 1) // 2)
    return x


# -- the generator on the kernel route's layout ---------------------------------

@pytest.fixture
def kernel_layout(monkeypatch):
    """The generator's kernel route on the CPU: the channels-last stages,
    transposed convolutions and conv_post on channels-last views fed by
    the activation pass; plain convolutions."""
    monkeypatch.setattr(hifigan_mrf, "use_kernel", lambda *args: True)


SMALL = dict(V1, Upsample_Initial_Channel=64)


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_layout_matches_the_reference_in_f32(kernel_layout, seed):
    gen, W = _generator(SMALL, seed=seed)
    mel = torch.rand((2, 9, N_MELS), generator=torch.Generator().manual_seed(seed + 10))
    with torch.no_grad():
        out = gen(mel)
    assert float((out - ref.generate(W, mel, SMALL)).abs().max()) <= F32_TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_layout_in_bf16_within_its_rounding(kernel_layout, seed):
    gen, W = _generator(SMALL, torch.bfloat16, seed)
    mel = torch.rand((2, 9, N_MELS), generator=torch.Generator().manual_seed(seed + 20))
    with torch.no_grad():
        out = gen(mel)
    assert 0.0 < _rel(out, ref.generate(W, mel, SMALL)) <= BF16_REL


def test_kernel_layout_stages_are_views_whose_rows_match_the_reference(kernel_layout):
    """Each stage returns a (B, C, L) view of a channels-last buffer; the
    rows' leading spans (a check's ``[j, ..., :span]``) match the reference
    stage on the same input, and forward is its own stages bit for bit."""
    gen, W = _generator(SMALL, torch.bfloat16)
    mel = torch.rand((3, 8, N_MELS), generator=torch.Generator().manual_seed(5))
    frames = (8, 5, 2)
    with torch.no_grad():
        acts = [gen.pre(mel)]
        for i in range(4):
            acts.append(gen.stage(i, acts[-1]))
        wav = gen.post(acts[-1])
        assert torch.equal(wav, gen(mel))
        per_frame = 1
        for i in range(4):
            x = acts[i + 1]
            C = 64 >> (i + 1)
            per_frame *= V1["Upsample_Rates"][i]
            assert x.shape == (3, C, 8 * per_frame)
            assert not x.is_contiguous() and x.transpose(1, 2).is_contiguous()
            want = ref_stage(W, i, acts[i])
            for j, f in enumerate(frames):
                span = f * per_frame
                assert _rel(x[j, ..., :span], want[j, ..., :span]) <= BF16_REL


def ref_stage(W, i, x):
    u, k = V1["Upsample_Rates"][i], V1["Upsample_Kernel_Sizes"][i]
    x = F.conv_transpose1d(F.leaky_relu(x, SLOPE), W[f"ups.{i}.weight"], W[f"ups.{i}.bias"],
                           stride=u, padding=(k - u) // 2)
    return sum(_ref_block(W, 3 * i + j, x, kk) for j, kk in enumerate((3, 7, 11))) / 3


def test_the_final_slope_is_read_when_post_runs(kernel_layout, monkeypatch):
    """post reads ``final_slope`` when it runs: a generator whose slope
    changed after its stages ran applies the new one."""
    gen, W = _generator(SMALL)
    mel = torch.rand((2, 5, N_MELS), generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        x = gen.pre(mel)
        for i in range(4):
            x = gen.stage(i, x)
        monkeypatch.setattr(HiFiGAN, "final_slope", 0.1)
        got = gen.post(x)
    want = ref.generate(W, mel, SMALL, final_slope=0.1)
    assert float((got - want).abs().max()) <= F32_TOL
