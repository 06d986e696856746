"""PyTorch/CUDA port of ``multi_speaker_tts_tpu`` for NVIDIA Hopper (H100).

A package of its own: it imports ``torch`` and never ``jax``, ``flax`` or
anything of the JAX package, and reads the same compact checkpoints. Every
Pallas kernel on the ported path is a hand-written CUDA kernel for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use; each wrapper
launches its kernel for CUDA tensors and runs its plain PyTorch version
for CPU tensors. Entry point: :class:`inference.Synthesizer`.
"""
