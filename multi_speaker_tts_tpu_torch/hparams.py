"""Hyper-parameter namespace (the port's own copy of ``Recursive_Parse``).

Compact checkpoints carry their hparams in ``meta["hp"]``, so the serving
path never reads YAML. The shipped defaults (``Hyper_Parameters.yaml`` of
the JAX package) are carried here as a Python dict, :data:`DEFAULTS`, so
that :func:`default_hparams` and :func:`tiny_test_hparams` need no
``pyyaml``; ``yaml`` is imported only by :func:`load_hyper_parameters` when
it is given a file, inside the function.
"""

from __future__ import annotations

import copy
import pathlib
from typing import Any, Mapping


class HParams:
    """Recursive attribute-access namespace over a nested dict.

    ``hp.Sound.Mel_Dim`` and ``hp["Sound"]["Mel_Dim"]`` both work; unknown
    attributes raise ``AttributeError`` naming the full dotted path.
    """

    def __init__(self, data: Mapping[str, Any], _path: str = ""):
        object.__setattr__(self, "_path", _path)
        object.__setattr__(self, "_data", {})
        for key, value in data.items():
            self._data[key] = self._wrap(key, value)

    def _wrap(self, key: str, value: Any) -> Any:
        child_path = f"{self._path}.{key}" if self._path else key
        if isinstance(value, Mapping):
            return HParams(value, child_path)
        if isinstance(value, list):
            return [
                HParams(v, f"{child_path}[{i}]") if isinstance(v, Mapping) else v
                for i, v in enumerate(value)
            ]
        return value

    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if name in data:
            return data[name]
        path = object.__getattribute__(self, "_path")
        full = f"{path}.{name}" if path else name
        raise AttributeError(f"No hyper-parameter '{full}'")

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = self._wrap(name, value)

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def to_dict(self) -> dict:
        out = {}
        for key, value in self._data.items():
            if isinstance(value, HParams):
                out[key] = value.to_dict()
            elif isinstance(value, list):
                out[key] = [
                    v.to_dict() if isinstance(v, HParams) else v for v in value
                ]
            else:
                out[key] = value
        return out

    def replace(self, **overrides: Any) -> "HParams":
        """Deep copy with top-level keys replaced (nested dicts merge)."""
        data = copy.deepcopy(self.to_dict())
        for key, value in overrides.items():
            if (
                key in data
                and isinstance(data[key], dict)
                and isinstance(value, Mapping)
            ):
                data[key] = _deep_merge(data[key], value)
            else:
                data[key] = value
        return HParams(data)

    def __repr__(self) -> str:
        return f"HParams({self.to_dict()!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, HParams):
            return self.to_dict() == other.to_dict()
        return NotImplemented


def _deep_merge(base: dict, override: Mapping) -> dict:
    out = dict(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, Mapping):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value) if isinstance(value, (dict, list)) else value
    return out


def Recursive_Parse(data: Mapping[str, Any]) -> HParams:
    """Reference-compatible entry point: dict -> namespace."""
    return HParams(data)


VOCODERS = ("Griffin_Lim", "HiFiGAN")


def vocoder_type(hp: HParams) -> str:
    """``Vocoder.Type``: ``Griffin_Lim`` (the default, also where the hp has
    no ``Vocoder`` section, as every checkpoint before the HiFi-GAN
    generator and :data:`DEFAULTS`, which mirror the JAX package's YAML) or
    ``HiFiGAN`` (``Vocoder.HiFiGAN``: the generator's widths and the
    ``Weights`` file, ``models/hifigan.py``)."""
    voc = hp.get("Vocoder")
    kind = "Griffin_Lim" if voc is None else voc.get("Type", "Griffin_Lim")
    if kind not in VOCODERS:
        raise NotImplementedError(f"unknown Vocoder.Type {kind!r}; known: {VOCODERS}")
    return kind


def load_hyper_parameters(path: str | pathlib.Path | None = None) -> HParams:
    """Read a reference-format Hyper_Parameters.yaml (needs ``pyyaml``), or
    the same tree as JSON (a ``.json`` path); no path gives
    :func:`default_hparams`."""
    if path is None:
        return default_hparams()
    if str(path).endswith(".json"):
        import json

        with open(path, "r", encoding="utf-8") as f:
            return Recursive_Parse(json.load(f))
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        return Recursive_Parse(yaml.safe_load(f))


def default_hparams(**overrides: Any) -> HParams:
    """The shipped default config, optionally with top-level overrides."""
    hp = HParams(copy.deepcopy(DEFAULTS))
    return hp.replace(**overrides) if overrides else hp


def tiny_test_hparams() -> HParams:
    """A miniature config for fast tests: the JAX package's
    ``tiny_test_hparams``, the same structure at tiny widths."""
    return default_hparams(
        Sound={"Sample_Rate": 16000, "Frame_Length": 256, "Frame_Shift": 64,
               "Spectrogram_Dim": 129, "Mel_Dim": 16, "Griffin_Lim_Iter": 8},
        Encoder={"Embedding_Size": 32,
                 "Conv": {"Stacks": 2, "Channels": 32, "Kernel_Size": 5, "Dropout_Rate": 0.5},
                 "LSTM_Size": 32},
        Speaker_Embedding={
            "Type": "GE2E", "Embedding_Size": 16,
            "GE2E": {"LSTM": {"Sizes": 32, "Stacks": 2}, "Window_Length": 24,
                     "Window_Shift": 12, "Loss": {"Initial_Weight": 10.0, "Initial_Bias": -5.0}},
        },
        Decoder={
            "Prenet": {"Sizes": [16, 16], "Dropout_Rate": 0.5},
            "Attention": {"Size": 32, "Conv": {"Channels": 8, "Kernel_Size": 15}},
            "LSTM": {"Sizes": 32, "Stacks": 2}, "N_Frames_Per_Step": 1, "Max_Step": 64,
            "Stop_Threshold": 0.5,
        },
        Postnet={"Conv": {"Stacks": 2, "Channels": 32, "Kernel_Size": 5, "Dropout_Rate": 0.5}},
        Linear_Head={
            "Use": True, "Type": "Conv",
            "CBHG": {"Bank_K": 4, "Bank_Channels": 16, "Projection_Channels": 16,
                     "Highway": {"Layers": 2, "Size": 16}, "GRU_Size": 16},
            "Conv": {"Stacks": 1, "Channels": 32, "Kernel_Size": 5, "Dropout_Rate": 0.5},
        },
        Train={"Batch_Size": 4, "Num_Workers": 0, "Max_Mel_Length": 64,
               "Max_Token_Length": 32, "Learning_Rate": {"Initial": 1e-3, "Warmup_Step": 10},
               "Weight_Decay": 1e-6, "Gradient_Norm": 1.0, "Use_Mixed_Precision": False},
    )


# multi_speaker_tts_tpu/Hyper_Parameters.yaml, as a dict.
DEFAULTS: dict = {'Sound': {'Sample_Rate': 22050,
           'Frame_Length': 1024,
           'Frame_Shift': 256,
           'Spectrogram_Dim': 513,
           'Mel_Dim': 80,
           'Mel_F_Min': 0,
           'Mel_F_Max': None,
           'Preemphasis': 0.97,
           'Min_Level_DB': -100.0,
           'Ref_Level_DB': 20.0,
           'Griffin_Lim_Iter': 60,
           'Griffin_Lim_Momentum': 0.0,
           'Power': 1.5,
           'Trim_Top_DB': 60.0,
           'Max_Wav_Value': 32768.0},
 'Tokens': {'Use_Phoneme': False, 'Phoneme_Lexicon': None, 'Cleaners': ['english_cleaners']},
 'Speaker_Embedding': {'Type': 'GE2E',
                       'Embedding_Size': 256,
                       'Num_Speakers': 256,
                       'GE2E': {'LSTM': {'Sizes': 768, 'Stacks': 3},
                                'Window_Length': 160,
                                'Window_Shift': 80,
                                'Backend': 'pallas',
                                'Loss': {'Initial_Weight': 10.0, 'Initial_Bias': -5.0},
                                'Pretrained_Checkpoint': None,
                                'Freeze': False}},
 'Encoder': {'Embedding_Size': 512,
             'Conv': {'Stacks': 3, 'Channels': 512, 'Kernel_Size': 5, 'Dropout_Rate': 0.5},
             'LSTM_Size': 512},
 'Decoder': {'Prenet': {'Sizes': [256, 256], 'Dropout_Rate': 0.5},
             'Attention': {'Size': 128, 'Conv': {'Channels': 32, 'Kernel_Size': 31}},
             'LSTM': {'Sizes': 1024, 'Stacks': 2},
             'N_Frames_Per_Step': 2,
             'Scan_Unroll': 2,
             'Early_Exit_Chunk': 16,
             'Quantize_Int8': False,
             'Max_Step': 1000,
             'Max_Frames_Per_Token': 12,
             'Stop_Threshold': 0.5},
 'Postnet': {'Conv': {'Stacks': 5, 'Channels': 512, 'Kernel_Size': 5, 'Dropout_Rate': 0.5}},
 'Linear_Head': {'Use': True,
                 'Type': 'CBHG',
                 'CBHG': {'Bank_K': 8,
                          'Bank_Channels': 128,
                          'Projection_Channels': 256,
                          'Highway': {'Layers': 4, 'Size': 128},
                          'GRU_Size': 256},
                 'Conv': {'Stacks': 2, 'Channels': 512, 'Kernel_Size': 5, 'Dropout_Rate': 0.5}},
 'Train': {'Batch_Size': 32,
           'Eval_Batch_Size': 8,
           'Max_Token_Length': 200,
           'Max_Mel_Length': 800,
           'Num_Workers': 4,
           'Learning_Rate': {'Initial': 0.001, 'Warmup_Step': 4000},
           'ADAM': {'Beta1': 0.9, 'Beta2': 0.999, 'Epsilon': 1e-07},
           'Weight_Decay': 1e-06,
           'Gradient_Norm': 1.0,
           'Use_Mixed_Precision': True,
           'Guided_Attention': {'Use': True, 'Sigma': 0.2, 'Weight': 10.0},
           'Train_Pattern': {'Path': './patterns/train',
                             'Metadata_File': 'METADATA.PICKLE',
                             'Accumulated_Dataset_Epoch': 1},
           'Eval_Pattern': {'Path': './patterns/eval', 'Metadata_File': 'METADATA.PICKLE'},
           'Batch_Bucketing': {'Token_Buckets': [50, 100, 150, 200],
                               'Mel_Buckets': [200, 400, 600, 800]},
           'Checkpoint_Save_Interval': 1000,
           'Logging_Interval': 100,
           'Evaluation_Interval': 1000,
           'Inference_Interval': 5000,
           'Max_Step': 300000},
 'GE2E_Train': {'Batch_Speakers': 16,
                'Batch_Utterances': 10,
                'Frame_Length': 160,
                'Learning_Rate': 0.0001,
                'Scale_Gradient': 0.01},
 'Inference': {'Batch_Size': 16, 'Path': './inference'},
 'Checkpoint_Path': './checkpoints',
 'Log_Path': './logs',
 'Use_Multi_GPU': False,
 'Device': '0'}
