"""Stand-alone tools of the torch port (``python -m multi_speaker_tts_tpu_torch.tools.<name>``)."""
