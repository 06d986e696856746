"""A torch ``state_dict`` into the JAX package's parameter layout (port of
``multi_speaker_tts_tpu/convert/torch_to_jax.py``).

The reference saves ``torch.save({'Model': state_dict, ...})``. These
helpers convert each torch module family to the flax layout that
``checkpoints.load_compact`` returns and ``weights.params_from_jax`` reads,
so everything downstream of a converted tree is unchanged:

- ``nn.Linear``:   weight (out, in)        -> kernel (in, out)
- ``nn.Conv1d``:   weight (out, in, k)     -> kernel (k, in, out)
- ``nn.LSTM``:     weight_ih (4H, D)       -> w_ih (D, 4H); torch's two bias
                   vectors are summed into one (the same function); gate
                   order (i, f, g, o) as ``ops.lstm``.
- ``nn.GRU``:      the same transposes, the two biases kept apart.
- ``nn.BatchNorm1d``: scale / bias + running mean / var -> flax BatchNorm
                   params and batch_stats.
- ``nn.Embedding``: copied as it is.

``convert_state_dict`` applies a ``{jax_path: (converter, [torch keys])}``
mapping (``convert.mapping``), so the reference's module names are data,
not code. Every converter does the JAX package's numpy arithmetic, so a
converted tree is bit-equal to the JAX converter's.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch


def _np(tensor) -> np.ndarray:
    if hasattr(tensor, "detach"):
        return tensor.detach().cpu().numpy()
    return np.asarray(tensor)


def convert_dense(weight, bias=None) -> dict:
    """torch Linear -> flax Dense {kernel, bias}."""
    out = {"kernel": _np(weight).T.copy()}
    if bias is not None:
        out["bias"] = _np(bias).copy()
    return out


def convert_conv1d(weight, bias=None) -> dict:
    """torch Conv1d (out, in, k) -> flax Conv {kernel (k, in, out), bias}."""
    out = {"kernel": np.transpose(_np(weight), (2, 1, 0)).copy()}
    if bias is not None:
        out["bias"] = _np(bias).copy()
    return out


def convert_lstm(weight_ih, weight_hh, bias_ih=None, bias_hh=None) -> dict:
    """torch LSTM layer -> {w_ih (D, 4H), w_hh (H, 4H), b (4H,)}."""
    w_ih = _np(weight_ih).T.copy()
    w_hh = _np(weight_hh).T.copy()
    b = np.zeros(w_ih.shape[1], np.float32)
    if bias_ih is not None:
        b = b + _np(bias_ih)
    if bias_hh is not None:
        b = b + _np(bias_hh)
    return {"w_ih": w_ih, "w_hh": w_hh, "b": b.astype(w_ih.dtype)}


def convert_gru(weight_ih, weight_hh, bias_ih, bias_hh) -> dict:
    """torch GRU layer -> {w_ih (D, 3H), w_hh (H, 3H), b_ih, b_hh}. The two
    biases stay apart: b_hn sits inside the reset product,
    n = tanh(W_in x + b_in + r (W_hn h + b_hn)) (``ops.gru``)."""
    return {
        "w_ih": _np(weight_ih).T.copy(),
        "w_hh": _np(weight_hh).T.copy(),
        "b_ih": _np(bias_ih).copy(),
        "b_hh": _np(bias_hh).copy(),
    }


def convert_batchnorm(weight, bias, running_mean, running_var) -> tuple[dict, dict]:
    """torch BatchNorm1d -> (flax params {scale, bias}, batch_stats {mean, var})."""
    params = {"scale": _np(weight).copy(), "bias": _np(bias).copy()}
    stats = {"mean": _np(running_mean).copy(), "var": _np(running_var).copy()}
    return params, stats


def convert_embedding(weight) -> dict:
    return {"embedding": _np(weight).copy()}


# A mapping is {jax_path: (converter, [torch_keys...])}.
Rule = tuple[Callable, list[str]]


def convert_state_dict(state_dict: Mapping, mapping: Mapping[str, Rule],
                       strict: bool = True) -> dict:
    """Apply a mapping to a torch state_dict -> ``{"params", "batch_stats"}``
    nested numpy trees. JAX paths nest with '/'; a converter returning a
    (params, stats) pair (BatchNorm) puts its stats under the same path of
    ``batch_stats``. ``strict=False`` skips rules whose torch keys are
    missing (and says how many)."""
    params: dict = {}
    stats: dict = {}
    missing = []
    for jax_path, (converter, torch_keys) in mapping.items():
        try:
            tensors = [state_dict[k] for k in torch_keys]
        except KeyError as e:
            if strict:
                raise KeyError(
                    f"torch key {e} (for '{jax_path}') not in state_dict; "
                    f"available sample: {list(state_dict)[:8]}"
                ) from None
            missing.append(jax_path)
            continue
        converted = converter(*tensors)
        if isinstance(converted, tuple):
            converted, stat = converted
            _set_path(stats, jax_path, stat)
        _set_path(params, jax_path, converted)
    if missing:
        print(f"convert_state_dict: skipped {len(missing)} unmapped paths")
    return {"params": params, "batch_stats": stats}


def _set_path(tree: dict, dotted: str, value) -> None:
    keys = dotted.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def load_torch_checkpoint(path: str):
    """Read a reference-style ``torch.save({'Model': state_dict, ...})`` file
    (or a bare state_dict) -> (state_dict, extras), on the CPU."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "Model" in blob:
        state_dict = blob["Model"]
        extras = {k: v for k, v in blob.items() if k != "Model"}
    elif isinstance(blob, dict) and all(hasattr(v, "shape") for v in blob.values()):
        state_dict, extras = blob, {}
    else:
        raise ValueError(
            f"unrecognized checkpoint structure: top-level keys {list(blob)[:8]}"
        )
    return state_dict, extras


def convert_reference_checkpoint(path: str, mapping: Mapping[str, Rule],
                                 strict: bool = True) -> dict:
    """torch checkpoint file + mapping -> {'params', 'batch_stats'[, 'step']}."""
    state_dict, extras = load_torch_checkpoint(path)
    tree = convert_state_dict(state_dict, mapping, strict=strict)
    if "Steps" in extras:
        tree["step"] = int(extras["Steps"])
    return tree
