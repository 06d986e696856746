"""Carry the JAX package's parameter trees over to the port's modules.

:func:`params_from_jax` takes ``(params, batch_stats)`` as numpy trees (what
``checkpoints.load_compact`` returns) and produces the port's state: one
flat ``{"ge2e.*" | "tacotron.*": array}`` dict whose keys are the
``state_dict`` keys of :class:`models.ge2e.GE2E` (prefix ``ge2e.``),
:class:`models.speaker.SpeakerLUT` (prefix ``speaker_lut.``) and
:class:`models.tacotron.Tacotron` (prefix ``tacotron.``).

Layouts stay the JAX ones (Dense kernels (in, out), LSTM gates i, f, g, o
in (D, 4H) / (H, 4H), the location conv (K, 2, C)), except the encoder and
postnet Conv_0 kernels, which go (K, in, out) -> torch's (out, in, K).
Every tensor the port's modules use is mapped exactly once, the linear head
(Conv or CBHG) included when ``Linear_Head.Use`` is on; the subtrees a
configuration does not use are named in :func:`unused_subtrees` and
skipped; any other unmapped or doubly mapped tensor raises.
:func:`params_to_jax` is the inverse: the port's state back to the JAX
trees, by the same rules read the other way.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _conv(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(k, (2, 1, 0)))


def _same(x: np.ndarray) -> np.ndarray:
    return x


# (tree, JAX path regex, port key template, transform)
_RULES = [
    ("params", r"ge2e/lstm_(\d+)/(w_ih|w_hh|b)", r"ge2e.lstm.\1.\2", _same),
    ("params", r"ge2e/projection/(kernel|bias)", r"ge2e.projection.\1", _same),
    ("params", r"speaker_lut/table/embedding", "speaker_lut.table.weight", _same),
    ("params", r"tacotron/encoder/embedding/embedding", "tacotron.encoder.embedding", _same),
    ("params", r"tacotron/encoder/bilstm/(forward|backward)/(w_ih|w_hh|b)",
     r"tacotron.encoder.bilstm.\1_dir.\2", _same),
    ("params", r"tacotron/decoder/memory_layer/kernel", "tacotron.decoder.memory_layer.kernel", _same),
    ("params", r"tacotron/decoder/prenet/dense_(\d+)/(kernel|bias)",
     r"tacotron.decoder.prenet.\1.\2", _same),
    ("params", r"tacotron/decoder/(frame_proj|stop_proj)/(kernel|bias)",
     r"tacotron.decoder.\1.\2", _same),
    ("params", r"tacotron/decoder/cell/lstm_(\d+)/(w_ih|w_hh|b)",
     r"tacotron.decoder.lstm.\1.\2", _same),
    ("params", r"tacotron/decoder/cell/attention/query_layer/kernel",
     "tacotron.decoder.attention.wq", _same),
    ("params", r"tacotron/decoder/cell/attention/location_conv/kernel",
     "tacotron.decoder.attention.conv_kernel", _same),
    ("params", r"tacotron/decoder/cell/attention/location_layer/kernel",
     "tacotron.decoder.attention.wloc", _same),
    ("params", r"tacotron/decoder/cell/attention/v/kernel", "tacotron.decoder.attention.v", _same),
]


def _conv_block_rules(jax_block: str, port_block: str) -> list:
    """Rules of one family of ``ConvBNBlock``s (regex of the JAX scope ->
    template of the port's module path)."""
    return [
        ("params", rf"{jax_block}/Conv_0/kernel", rf"{port_block}.weight", _conv),
        ("params", rf"{jax_block}/Conv_0/bias", rf"{port_block}.bias", _same),
        ("params", rf"{jax_block}/BatchNorm_0/(scale|bias)", rf"{port_block}.bn_\2", _same),
        ("batch_stats", rf"{jax_block}/BatchNorm_0/(mean|var)", rf"{port_block}.bn_\2", _same),
    ]


_HEAD, _PORT_HEAD = "tacotron/linear_head", "tacotron.linear_head"
for _stack in ("encoder", "postnet"):
    _RULES += _conv_block_rules(rf"tacotron/{_stack}/conv_(\d+)", rf"tacotron.{_stack}.convs.\1")
# Linear head, Conv variant (conv_i, projection) and CBHG variant.
_RULES += _conv_block_rules(rf"{_HEAD}/conv_(\d+)", rf"{_PORT_HEAD}.convs.\1")
_RULES += _conv_block_rules(rf"{_HEAD}/cbhg/bank_(\d+)", rf"{_PORT_HEAD}.cbhg.bank.\1")
_RULES += _conv_block_rules(rf"{_HEAD}/cbhg/proj_(\d+)", rf"{_PORT_HEAD}.cbhg.proj_\1")
_RULES += [
    ("params", rf"{_HEAD}/projection/(kernel|bias)", rf"{_PORT_HEAD}.projection.\1", _same),
    ("params", rf"{_HEAD}/cbhg/pre_highway/(kernel|bias)",
     rf"{_PORT_HEAD}.cbhg.pre_highway.\1", _same),
    ("params", rf"{_HEAD}/cbhg/highway_(\d+)/(H|T)/(kernel|bias)",
     rf"{_PORT_HEAD}.cbhg.highways.\1.\2.\3", _same),
    ("params", rf"{_HEAD}/cbhg/gru/(forward|backward)/(w_ih|w_hh|b_ih|b_hh)",
     rf"{_PORT_HEAD}.cbhg.gru.\1_dir.\2", _same),
]


def unused_subtrees(hp) -> set[str]:
    """JAX subtrees this configuration carries but does not run: the linear
    head of a checkpoint served mel-only (``Linear_Head.Use: false``)."""
    lh = hp.get("Linear_Head")
    return set() if lh is not None and lh.Use else {"tacotron/linear_head"}


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, path + "/"))
        else:
            out[path] = np.asarray(value)
    return out


def params_from_jax(params: dict, batch_stats: dict, hp) -> dict[str, np.ndarray]:
    """JAX (params, batch_stats) numpy trees -> the port's flat state."""
    skip = unused_subtrees(hp)
    state: dict[str, np.ndarray] = {}
    sources: dict[str, str] = {}
    for tree_name, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, value in _flatten(tree).items():
            if any(path == s or path.startswith(s + "/") for s in skip):
                continue
            hits = [
                (re.sub(pattern, template, path), fn)
                for tree_of, pattern, template, fn in _RULES
                if tree_of == tree_name and re.fullmatch(pattern, path)
            ]
            if len(hits) != 1:
                raise ValueError(
                    f"{tree_name}/{path}: {len(hits)} mapping rules match "
                    "(expected exactly one)"
                )
            key, fn = hits[0]
            if key in state:
                raise ValueError(f"{key} mapped twice: {sources[key]} and {tree_name}/{path}")
            state[key] = np.asarray(fn(value), np.float32)
            sources[key] = f"{tree_name}/{path}"
    return state


_GROUP = re.compile(r"\([^()]*\)")


def _inverse_rule(pattern: str, template: str) -> tuple[str, str]:
    """(regex of port keys, template of JAX paths) of one rule: the k-th
    group of the JAX pattern is the k-th ``\\k`` of the port template (each
    rule uses its groups once, in order)."""
    groups = _GROUP.findall(pattern)
    pieces = re.split(r"\\(\d)", template)
    regex = "".join(re.escape(x) if i % 2 == 0 else groups[int(x) - 1]
                    for i, x in enumerate(pieces))
    count = iter(range(1, len(groups) + 1))
    return regex, _GROUP.sub(lambda m: f"\\{next(count)}", pattern)


_INVERSE = [(tree, *_inverse_rule(pattern, template), fn)
            for tree, pattern, template, fn in _RULES]


def params_to_jax(state: dict, hp) -> tuple[dict, dict]:
    """The port's flat state (numpy arrays or tensors) -> JAX (params,
    batch_stats) numpy trees: the inverse of :func:`params_from_jax` (conv
    kernels back to (K, in, out)). Every key must match exactly one rule."""
    del hp  # the keys say everything; kept for symmetry with params_from_jax
    trees: dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        hits = [(tree, re.sub(regex, template, key), fn)
                for tree, regex, template, fn in _INVERSE if re.fullmatch(regex, key)]
        if len(hits) != 1:
            raise ValueError(f"{key}: {len(hits)} mapping rules match (expected exactly one)")
        tree, path, fn = hits[0]
        node = trees[tree]
        *scopes, leaf = path.split("/")
        for scope in scopes:
            node = node.setdefault(scope, {})
        if leaf in node:
            raise ValueError(f"{tree}/{path} mapped twice")
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else value
        node[leaf] = np.asarray(fn(np.asarray(arr, np.float32)))
    return trees["params"], trees["batch_stats"]


def module_state(**modules) -> dict[str, np.ndarray]:
    """``{prefix.key: array}`` from modules by prefix (``ge2e=...``,
    ``tacotron=...``): the flat state :func:`params_to_jax` reads. The
    arrays are copies: a later in-place update does not reach them."""
    return {f"{prefix}.{k}": v.detach().cpu().numpy().copy()
            for prefix, module in modules.items() if module is not None
            for k, v in module.state_dict().items()}


def load_into(module, state: dict[str, np.ndarray], prefix: str) -> None:
    """Copy ``prefix``-ed entries of ``state`` into ``module`` (strict: every
    parameter and buffer filled, nothing left over, shapes equal)."""
    own = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    expected = module.state_dict()
    missing = sorted(set(expected) - set(own))
    extra = sorted(set(own) - set(expected))
    if missing or extra:
        raise ValueError(f"{prefix}: missing {missing[:5]}, unexpected {extra[:5]}")
    for key, value in own.items():
        if tuple(expected[key].shape) != value.shape:
            raise ValueError(f"{prefix}{key}: shape {value.shape} != {tuple(expected[key].shape)}")
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in own.items()})


_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _init_leaf(path: str, shape: tuple, generator: torch.Generator) -> torch.Tensor:
    """One parameter of a fresh model, by its JAX path, from the family the
    JAX package's initializer draws it from: recurrent weights and biases
    U(-1/sqrt(H), 1/sqrt(H)); Dense and Conv kernels lecun-normal (a normal
    truncated to two deviations, variance 1/fan_in); ``nn.Embed`` tables
    N(0, 1/E); biases 0, the highway gates' -1; BatchNorm scales 1."""
    leaf = path.rsplit("/", 1)[-1]
    if leaf in ("w_ih", "w_hh", "b", "b_ih", "b_hh"):
        H = shape[-1] // (3 if "/gru/" in path else 4)
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) / H ** 0.5
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        t = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
        return t * ((1.0 / fan_in) ** 0.5 / _TRUNC_STD)
    if leaf == "embedding":
        return torch.randn(shape, generator=generator) * (1.0 / shape[-1]) ** 0.5
    if leaf == "bias":
        return torch.full(shape, -1.0 if re.search(r"/highway_\d+/T/bias$", path) else 0.0)
    if leaf == "scale":
        return torch.ones(shape)
    raise ValueError(f"no initializer for parameter {path}")


def random_init(hp, generator: torch.Generator, **modules) -> tuple[dict, dict]:
    """Fill ``modules`` (by prefix: ``ge2e=``, ``speaker_lut=``,
    ``tacotron=``) with a fresh init drawn from ``generator`` (a CPU
    generator), each tensor from its JAX initializer's family
    (:func:`_init_leaf`; BatchNorm running mean 0, variance 1). Returns the
    (params, batch_stats) JAX trees of the init."""
    params, batch_stats = params_to_jax(module_state(**modules), hp)

    def fill(tree, path, fn):
        return {k: fill(v, f"{path}/{k}", fn) if isinstance(v, dict) else fn(f"{path}/{k}", v)
                for k, v in tree.items()}

    params = fill(params, "", lambda p, v: _init_leaf(p, v.shape, generator).numpy())
    batch_stats = fill(batch_stats, "", lambda p, v: (np.ones_like(v) if p.endswith("/var")
                                                       else np.zeros_like(v)))
    state = params_from_jax(params, batch_stats, hp)
    for prefix, module in modules.items():
        if module is not None:
            load_into(module, state, f"{prefix}.")
    return params, batch_stats
