"""The training CLI's ``-debug_nans`` (port of the JAX CLI's
``jax_debug_nans``, which raises at the first operation that makes a NaN).

:func:`install` hooks every submodule of the given models: a forward hook
raises ``FloatingPointError`` at the first module whose output holds a NaN
or an infinity, and a gradient hook on each of a module's inputs raises at
the first module whose backward output (the gradient of an input) does,
either naming the module. Each check reads the tensor back to the host, so
a step runs slower, as it does under the JAX flag.
"""

from __future__ import annotations

import functools

import torch


def _tensors(x) -> list:
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in _tensors(item)]
    if isinstance(x, dict):
        return [t for item in x.values() for t in _tensors(item)]
    return []


def _check(name: str, what: str, t: torch.Tensor) -> None:
    if t.is_floating_point() and not bool(torch.isfinite(t).all()):
        raise FloatingPointError(f"-debug_nans: non-finite {what} of module {name!r}")


def _grad_hook(name: str, grad: torch.Tensor) -> None:
    _check(name, "backward output (an input's gradient)", grad)


def _forward_hook(name: str, module, inputs, output) -> None:
    for t in _tensors(output):
        _check(name, "forward output", t)
    if torch.is_grad_enabled():
        for t in _tensors(inputs):
            if t.requires_grad:
                t.register_hook(functools.partial(_grad_hook, name))


def install(models: dict) -> list:
    """Hook every submodule of each ``{prefix: module}`` (None skipped);
    returns the handles."""
    handles = []
    for prefix, root in models.items():
        if root is None:
            continue
        for name, mod in root.named_modules(prefix=prefix):
            handles.append(mod.register_forward_hook(functools.partial(_forward_hook, name)))
    return handles


def trainer_models(trainer) -> dict:
    """The modules a trainer trains: the GE2E trainer's encoder, or the
    TTS trainer's Tacotron, GE2E encoder and speaker table."""
    if hasattr(trainer, "tacotron"):
        return {"tacotron": trainer.tacotron, "ge2e": trainer.ge2e,
                "speaker_lut": trainer.speaker_lut}
    return {"encoder": trainer.model}
