"""Faults of the HiFi-GAN cell's vocoder (``synth_hifigan.b32-short``),
planted underneath its timed path for the check to catch, in the form of
``faults.py``'s (each takes ``patch(owner, name, value)``; plant them
with ``faults.patcher()`` at the cell's size on the card).
``benchmark/tests/test_bench_hifigan.py`` plants them on the CPU."""

from __future__ import annotations


def wave_row_altered(patch):
    """One row's generator output (row 1) scaled by 1.02 as it is produced."""
    from multi_speaker_tts_tpu_torch.models import hifigan

    forward = hifigan.HiFiGAN.forward

    def altered(self, mel):
        out = forward(self, mel).clone()
        out[min(1, out.shape[0] - 1)] *= 1.02
        return out

    patch(hifigan.HiFiGAN, "forward", altered)


def mrf_branch_dropped(patch):
    """Each MRF the mean of its ResBlock1s without the last (kernel 11 in V1)."""
    from multi_speaker_tts_tpu_torch.models import hifigan

    def mrf(self, i, x):
        blocks = self.resblocks[i * self.n_kernels:(i + 1) * self.n_kernels][:-1]
        return sum(block(x, self.compute_dtype) for block in blocks) / len(blocks)

    patch(hifigan.HiFiGAN, "mrf", mrf)


def final_slope_wrong(patch):
    """The LeakyReLU before conv_post at 0.1, the stages' slope, not 0.01."""
    from multi_speaker_tts_tpu_torch.models import hifigan

    patch(hifigan.HiFiGAN, "final_slope", 0.1)


FAULTS = [wave_row_altered, mrf_branch_dropped, final_slope_wrong]
