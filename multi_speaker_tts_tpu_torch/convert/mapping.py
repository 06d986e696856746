"""Full-model mapping tables, reference torch keys -> the JAX package's
parameter paths (port of ``multi_speaker_tts_tpu/convert/mapping.py``, the
same tables, key for key).

A mapping is ``{jax_path: (converter, [torch_state_dict_keys])}``, consumed
by ``convert.state_dict.convert_state_dict``. The torch-side names are
those of ``convert.reference_torch``, the reconstructed reference
architecture; a checkpoint whose names differ needs only its torch keys
renamed here. The converted tree is what ``checkpoints.load_compact``
returns, so ``weights.params_from_jax``, ``Synthesizer`` and
``train.checkpoints.export_compact`` take it as they take any checkpoint.
"""

from __future__ import annotations

from multi_speaker_tts_tpu_torch.convert.state_dict import (
    Rule,
    convert_batchnorm,
    convert_conv1d,
    convert_dense,
    convert_embedding,
    convert_gru,
    convert_lstm,
    convert_reference_checkpoint,
)


def _lstm_keys(prefix: str, layer: int | None = None, reverse: bool = False):
    """torch nn.LSTM / nn.LSTMCell parameter key quadruple."""
    suffix = "" if layer is None else f"_l{layer}"
    if reverse:
        suffix += "_reverse"
    return [
        f"{prefix}.weight_ih{suffix}",
        f"{prefix}.weight_hh{suffix}",
        f"{prefix}.bias_ih{suffix}",
        f"{prefix}.bias_hh{suffix}",
    ]


def _dense_keys(prefix: str, bias: bool = True):
    keys = [f"{prefix}.weight"]
    if bias:
        keys.append(f"{prefix}.bias")
    return keys


def _conv_bn_rules(jax_prefix: str, conv_key: str, norm_key: str) -> dict[str, Rule]:
    """One ConvBNBlock: flax auto-names the submodules Conv_0/BatchNorm_0."""
    return {
        f"{jax_prefix}/Conv_0": (convert_conv1d, _dense_keys(conv_key)),
        f"{jax_prefix}/BatchNorm_0": (
            convert_batchnorm,
            [
                f"{norm_key}.weight",
                f"{norm_key}.bias",
                f"{norm_key}.running_mean",
                f"{norm_key}.running_var",
            ],
        ),
    }


def tacotron_mapping(hp, jax_root: str = "tacotron") -> dict[str, Rule]:
    """Synthesizer mapping: every parameter of ``models.Tacotron``."""
    m: dict[str, Rule] = {}

    # Encoder: embedding -> conv stack -> BiLSTM (SURVEY.md section 2).
    m[f"{jax_root}/encoder/embedding"] = (
        convert_embedding, ["encoder.embedding.weight"],
    )
    for i in range(hp.Encoder.Conv.Stacks):
        m.update(_conv_bn_rules(
            f"{jax_root}/encoder/conv_{i}",
            f"encoder.convs.{i}", f"encoder.norms.{i}",
        ))
    m[f"{jax_root}/encoder/bilstm/forward"] = (
        convert_lstm, _lstm_keys("encoder.lstm", 0),
    )
    m[f"{jax_root}/encoder/bilstm/backward"] = (
        convert_lstm, _lstm_keys("encoder.lstm", 0, reverse=True),
    )

    # Decoder: memory/key projection lives outside the scanned cell.
    m[f"{jax_root}/decoder/memory_layer"] = (
        convert_dense, _dense_keys("decoder.attention.memory_layer", bias=False),
    )
    for i in range(len(hp.Decoder.Prenet.Sizes)):
        m[f"{jax_root}/decoder/prenet/dense_{i}"] = (
            convert_dense, _dense_keys(f"decoder.prenet.layers.{i}"),
        )
    for i in range(hp.Decoder.LSTM.Stacks):
        m[f"{jax_root}/decoder/cell/lstm_{i}"] = (
            convert_lstm, _lstm_keys(f"decoder.cells.{i}"),
        )
    for name in ("query_layer", "location_conv", "location_layer", "v"):
        conv = convert_conv1d if name == "location_conv" else convert_dense
        m[f"{jax_root}/decoder/cell/attention/{name}"] = (
            conv, _dense_keys(f"decoder.attention.{name}", bias=False),
        )
    m[f"{jax_root}/decoder/frame_proj"] = (
        convert_dense, _dense_keys("decoder.frame_proj"),
    )
    m[f"{jax_root}/decoder/stop_proj"] = (
        convert_dense, _dense_keys("decoder.stop_proj"),
    )

    # Postnet.
    for i in range(hp.Postnet.Conv.Stacks):
        m.update(_conv_bn_rules(
            f"{jax_root}/postnet/conv_{i}",
            f"postnet.convs.{i}", f"postnet.norms.{i}",
        ))

    # Linear branch (optional): CBHG (reference design) or conv stand-in.
    lh = hp.get("Linear_Head")
    if lh is not None and lh.Use:
        if lh.get("Type", "Conv") == "CBHG":
            cb = lh.CBHG
            root = f"{jax_root}/linear_head/cbhg"
            for i in range(cb.Bank_K):
                m.update(_conv_bn_rules(
                    f"{root}/bank_{i}",
                    f"linear_head.cbhg.bank.{i}",
                    f"linear_head.cbhg.bank_norms.{i}",
                ))
            for j in range(2):
                m.update(_conv_bn_rules(
                    f"{root}/proj_{j}",
                    f"linear_head.cbhg.projs.{j}",
                    f"linear_head.cbhg.proj_norms.{j}",
                ))
            if hp.Sound.Mel_Dim != cb.Highway.Size:
                m[f"{root}/pre_highway"] = (
                    convert_dense, _dense_keys("linear_head.cbhg.pre_highway"),
                )
            for i in range(cb.Highway.Layers):
                for gate in ("H", "T"):
                    m[f"{root}/highway_{i}/{gate}"] = (
                        convert_dense,
                        _dense_keys(f"linear_head.cbhg.highways.{i}.{gate}"),
                    )
            m[f"{root}/gru/forward"] = (
                convert_gru, _lstm_keys("linear_head.cbhg.gru", 0),
            )
            m[f"{root}/gru/backward"] = (
                convert_gru, _lstm_keys("linear_head.cbhg.gru", 0, reverse=True),
            )
        else:
            for i in range(lh.Conv.Stacks):
                m.update(_conv_bn_rules(
                    f"{jax_root}/linear_head/conv_{i}",
                    f"linear_head.convs.{i}", f"linear_head.norms.{i}",
                ))
        m[f"{jax_root}/linear_head/projection"] = (
            convert_dense, _dense_keys("linear_head.projection"),
        )
    return m


def ge2e_mapping(hp, jax_root: str = "ge2e",
                 torch_prefix: str = "ge2e") -> dict[str, Rule]:
    """GE2E encoder mapping: stacked-LSTM layers + projection."""
    m: dict[str, Rule] = {}
    for i in range(hp.Speaker_Embedding.GE2E.LSTM.Stacks):
        m[f"{jax_root}/lstm_{i}"] = (
            convert_lstm, _lstm_keys(f"{torch_prefix}.lstm", i),
        )
    m[f"{jax_root}/projection"] = (
        convert_dense, _dense_keys(f"{torch_prefix}.projection"),
    )
    return m


def full_mapping(hp) -> dict[str, Rule]:
    """Synthesizer + (if configured) GE2E, under the Trainer's param roots."""
    m = tacotron_mapping(hp)
    if hp.Speaker_Embedding.get("Type") == "GE2E":
        m.update(ge2e_mapping(hp))
    return m


def convert_full_checkpoint(path: str, hp, strict: bool = True) -> dict:
    """Reference-style torch checkpoint file -> Trainer-shaped trees:
    ``{'params': {'tacotron': ..., 'ge2e': ...}, 'batch_stats':
    {'tacotron': ...}, 'step': int}``."""
    return convert_reference_checkpoint(path, full_mapping(hp), strict=strict)
