"""Training logs (port of ``multi_speaker_tts_tpu.train.logger``): scalars,
alignment images and audio samples under the JAX package's tag names,
written by ``torch.utils.tensorboard`` where ``tensorboard`` imports, and
the scalars printed to stdout otherwise."""

from __future__ import annotations

import pathlib

import numpy as np


class Logger:
    """A TensorBoard writer over ``log_dir``, or stdout without one."""

    def __init__(self, log_dir: str | pathlib.Path):
        self.log_dir = pathlib.Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(str(self.log_dir))
        except ImportError as e:
            print(f"TensorBoard unavailable ({e}); logging scalars to stdout")
            self._writer = None

    def add_scalar(self, tag: str, value, step: int) -> None:
        value = float(np.asarray(value))
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)
        else:
            print(f"[step {step}] {tag} = {value:.5f}")

    def add_scalar_dict(self, prefix: str, values: dict, step: int) -> None:
        for key, value in values.items():
            self.add_scalar(f"{prefix}/{key}", value, step)

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """image: (H, W) or (H, W, C) floats in [0, 1]."""
        if self._writer is None:
            return
        image = np.asarray(image, np.float32)
        if image.ndim == 2:
            image = image[..., None]
        self._writer.add_image(tag, image, step, dataformats="HWC")

    def add_audio(self, tag: str, wav: np.ndarray, step: int, sample_rate: int) -> None:
        if self._writer is None:
            return
        wav = np.asarray(wav, np.float32).reshape(-1)
        peak = np.abs(wav).max() if wav.size else 0.0
        if peak > 1.0:
            wav = wav / peak
        self._writer.add_audio(tag, wav, step, sample_rate=sample_rate)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class NullLogger(Logger):
    """Writes nothing (for the processes other than the first of a
    multi-process run)."""

    def __init__(self, log_dir: str | pathlib.Path):
        self.log_dir = pathlib.Path(log_dir)
        self._writer = None

    def add_scalar(self, tag: str, value, step: int) -> None:
        pass
