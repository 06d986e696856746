"""Data parallelism over ``torch.distributed`` (port of
``multi_speaker_tts_tpu.parallel``): :mod:`.multihost` for the process
group of a multi-process training run, :mod:`.mesh` for the devices one
process drives in sharded synthesis."""
