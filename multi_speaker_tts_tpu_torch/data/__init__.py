"""Batch layout of training: ``collate_tts``."""
