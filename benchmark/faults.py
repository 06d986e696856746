"""Faults planted underneath a cell's timed path, for the check to catch:
each takes ``patch(owner, name, value)`` (pytest's ``monkeypatch.setattr``,
or :func:`patcher`'s) and breaks the program where it produces its answer.
``benchmark/tests/test_bench_faults.py`` plants them at a small size on the
CPU, ``control.py --fault <name>`` at a cell's own size on the card."""

from __future__ import annotations

import torch


def patcher():
    """-> (patch, undo): a ``setattr`` that remembers what it replaced."""
    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo():
        while saved:
            setattr(*saved.pop())

    return patch, undo


def frame_altered(patch):
    """One decoded frame of row 0 altered as the decoder returns it."""
    from multi_speaker_tts_tpu_torch.models import tacotron

    infer = tacotron.Decoder.infer

    def altered(self, *a, **k):
        mel, stops, aligns, lengths = infer(self, *a, **k)
        mel = mel.clone()
        mel[0, 3] += 0.5  # row 0, the second frame of step 1
        return mel, stops, aligns, lengths

    patch(tacotron.Decoder, "infer", altered)


def _stale_rows(patch, rows_of):
    """The decode chunk leaves the state of rows ``rows_of(B)`` unchanged."""
    from multi_speaker_tts_tpu_torch.ops import decode_kernel

    segment = decode_kernel.decoder_ar_segment_kernel

    def keep(new, old, rows):
        if isinstance(new, tuple):
            return tuple(keep(n, o, rows) for n, o in zip(new, old))
        new = new.clone()
        new[rows] = old[rows]
        return new

    def stale(bundle, keys, memory, mask, carry, *a, **k):
        new, *rest = segment(bundle, keys, memory, mask, carry, *a, **k)
        rows = rows_of(carry.context.shape[0])
        return (type(carry)(*(keep(n, o, rows) for n, o in zip(new, carry))), *rest)

    patch(decode_kernel, "decoder_ar_segment_kernel", stale)


def decode_state_unchanged(patch):
    """Every decode chunk returns the state it was given."""
    _stale_rows(patch, lambda B: slice(None))


def one_row_stale(patch):
    """The decode chunks leave one row's state (row 5) unchanged."""
    _stale_rows(patch, lambda B: slice(min(5, B - 1), min(5, B - 1) + 1))


def row_group_stale(patch):
    """The decode chunks leave the second half of the rows unchanged: the
    decode kernel's second row group of 16 at 32 rows."""
    _stale_rows(patch, lambda B: slice(B // 2, B))


def vocode_row_altered(patch):
    """The vocoder's waveform of row 1 scaled by 1.05 as it is produced."""
    from multi_speaker_tts_tpu_torch.ops import stft_matmul

    gl = stft_matmul.griffin_lim_auto
    gl = getattr(gl, "served_by", gl)  # under a harness's capture of another set-up

    def altered(*a, **k):
        out = gl(*a, **k).clone()
        out[min(1, out.shape[0] - 1)] *= 1.05
        return out

    patch(stft_matmul, "griffin_lim_auto", altered)


def state_unchanged(patch):
    """A GE2E training step that updates nothing."""
    from multi_speaker_tts_tpu_torch.train import ge2e_trainer

    def no_update(self, mels):
        loss, _ = self.gradients(mels)
        return {"loss": float(loss), "w": 0.0, "b": 0.0}

    patch(ge2e_trainer.GE2ETrainer, "train_step", no_update)


def half_batch(patch):
    """GE2E's loss over half of the batch, the mean taken over the rest."""
    from multi_speaker_tts_tpu_torch.train import ge2e_trainer

    loss = ge2e_trainer.ge2e_loss
    patch(ge2e_trainer, "ge2e_loss", lambda emb, w, b: loss(emb[:emb.shape[0] // 2], w, b))


def embedding_altered(patch):
    """One served embedding (row 0) altered as it is produced."""
    from multi_speaker_tts_tpu_torch.models import ge2e

    embed = ge2e.GE2E.embed_utterance

    def altered(self, *a, **k):
        out = embed(self, *a, **k).clone()
        out[0] = torch.nn.functional.normalize(out[0] + 0.2, dim=-1)
        return out

    patch(ge2e.GE2E, "embed_utterance", altered)


BY_CELL = {
    "synth.b32-short": [frame_altered, decode_state_unchanged, one_row_stale, row_group_stale,
                        vocode_row_altered],
    "ge2e_train.n64m10": [state_unchanged, half_batch],
    "ge2e_embed.b64": [embedding_altered],
}
