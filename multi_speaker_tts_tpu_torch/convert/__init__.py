"""Reference torch checkpoints into the port: the converters, the mapping
tables, the port's copy of the reconstructed reference model, and the CLI
(``python -m multi_speaker_tts_tpu_torch.convert``)."""

from multi_speaker_tts_tpu_torch.convert.state_dict import (  # noqa: F401
    convert_batchnorm,
    convert_conv1d,
    convert_dense,
    convert_embedding,
    convert_gru,
    convert_lstm,
    convert_state_dict,
)
