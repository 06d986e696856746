"""Convert a reference-style torch checkpoint into a servable compact file.

    python -m multi_speaker_tts_tpu_torch.convert \
        -in S_100000.pt -hp Hyper_Parameters.yaml -out converted.msgpack

One command from the reference's ``torch.save`` file to the compact
inference checkpoint (``train.checkpoints.export_compact``: f16 arrays in
the JAX package's layout, with ``meta = {"hp", "source",
"trained_steps"}``), the file the JAX package's CLI of the same flags
writes, byte for byte. ``Synthesizer.from_compact`` and the inference CLI
and daemon load it. ``-hp`` reads YAML through ``pyyaml`` (or the same tree
as ``.json``); without it the shipped defaults are used. The mapping
tables are in ``convert/mapping.py``.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="torch checkpoint -> compact serving checkpoint"
    )
    parser.add_argument("-in", dest="input", required=True,
                        help="reference torch checkpoint (.pt)")
    parser.add_argument("-hp", "--hyper_parameters", default=None,
                        help="the checkpoint's hparams YAML (or JSON); the reference "
                             "and this package share the format")
    parser.add_argument("-out", required=True,
                        help="output .msgpack compact checkpoint")
    parser.add_argument("-no_strict", action="store_true",
                        help="ignore unmapped torch keys instead of failing")
    args = parser.parse_args(argv)

    from multi_speaker_tts_tpu_torch.convert.mapping import convert_full_checkpoint
    from multi_speaker_tts_tpu_torch.hparams import load_hyper_parameters
    from multi_speaker_tts_tpu_torch.train.checkpoints import export_compact

    hp = load_hyper_parameters(args.hyper_parameters)
    tree = convert_full_checkpoint(args.input, hp, strict=not args.no_strict)
    meta = {"hp": hp.to_dict(), "source": args.input}
    if "step" in tree:
        meta["trained_steps"] = int(tree["step"])
    export_compact(args.out, tree["params"], tree.get("batch_stats", {}), meta=meta)
    n = sum(np.asarray(v).size for v in _leaves(tree["params"]))
    print(f"wrote {args.out}: {n / 1e6:.2f}M params"
          + (f", step {tree['step']}" if "step" in tree else ""))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
