"""What the probe tools share: the card's name and power limit, and wall
times of work on a device with the device held in step with the host."""

from __future__ import annotations

import subprocess
import time

import torch


def card(device) -> str:
    """``nvidia-smi``'s name and power limit of the card on a CUDA device,
    else the device's type."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    return out.splitlines()[torch.cuda.current_device()] if out else torch.cuda.get_device_name()


def wall_s(fn, n: int, device) -> float:
    """Seconds of ``n`` calls of ``fn``, a CUDA device synchronized before the
    first and after the last."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if on_card:
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def per_call_ms(fn, device, lo: int = 1, hi: int = 5, reps: int = 3) -> float:
    """ms a call from a two-point slope, the best of ``reps`` at each point
    (the JAX tools' ``(min(run(5)) - min(run(1))) / 4``): the fixed cost of
    a measurement cancels."""
    t_lo = min(wall_s(fn, lo, device) for _ in range(reps))
    t_hi = min(wall_s(fn, hi, device) for _ in range(reps))
    return (t_hi - t_lo) / (hi - lo) * 1e3
