"""Zero-shot synthesis API (port of ``multi_speaker_tts_tpu.inference``).

``Synthesizer.from_compact(path)`` -> ``enroll(wavs)`` -> ``synthesize(texts,
embedding)`` -> waveforms, on a CUDA device by default:

- enroll: wav -> wrap-pad to a pow2 bucket -> fused mel front-end kernel ->
  GE2E windows -> persistent LSTM kernel -> mean of the window embeddings;
- synthesize: text -> tokens in pow2 batch and 16-multiple token buckets ->
  text encoder (BiLSTM kernel) -> early-exit AR decode (a Python loop of
  steps, or under ``quantize="int8_pallas" | "bf16_pallas"`` the K-step
  decode kernel) -> masked postnet -> linear head over the whole decode
  bucket (CBHG with the BiGRU kernel, or the Conv stack; mel-only models
  use the filterbank pseudo-inverse instead) -> magnitudes at a pow2 bucket
  of the longest decoded length (or the whole decode bucket with
  ``split_vocode=False``) -> Griffin-Lim (the staged or the dense kernel by
  the JAX package's route; the FFT route when the hop does not divide
  n_fft) -> inverse preemphasis -> optional 16-bit PCM; under
  ``Vocoder.Type: HiFiGAN`` the HiFi-GAN V1 generator
  (:mod:`.models.hifigan`, weights given as ``vocoder_params``) reads the
  postnet's mel at the same bucket in place of magnitudes, Griffin-Lim
  and inverse preemphasis;
- sharded synthesis (``Synthesizer(mesh=...)``, ``synthesize(sharded=True)``):
  the padded batch in contiguous row shards, one a device of the mesh,
  each decoded by that device's replica of the weights under its rows of
  the whole batch's prenet masks, all vocoded at one bucket;
- stream: the same decode in segments of K steps, each block of frames
  emitted one segment later through the postnet / Conv head on a window
  with exact halos and windowed Griffin-Lim, crossfaded into the previous
  window's tail: constant time to the first chunk.

The buckets are part of the result (Griffin-Lim phase couples into the
padding), so they follow the JAX package exactly. ``synthesize`` carries
profiler spans (:mod:`.telemetry`): ``synth.call`` around the whole call;
inside it ``synth.prepare`` (tokens, buckets, host-to-device copies, the
prenet mask sampler), ``synth.encoder``, ``synth.decode``, ``synth.postnet``,
``synth.linear``, ``synth.vocode`` (the generator's stages inside it as
``vocode.up0`` ..) and ``synth.return`` (the copies to the host, the
joins, the per-row results). The decode counts ``decode.row_steps`` a
chunk and the vocoder ``vocode.row_frames`` a call.
Without a profiler a count is one check of the profiler's flag and a span
that check and a shared no-op context: on an H100 machine's host a span
took 0.41-0.45 us and a count 0.16-0.25 us, ``record_function`` 10-12 us.

CLI (the card by default; ``-device cpu`` runs the plain versions)::

    python -m multi_speaker_tts_tpu_torch.inference -checkpoint demo/serving_ckpt_full.msgpack \
        -text "..." [-ref enroll1.wav -ref enroll2.wav | -speaker_id N] [-stream] -out <dir>

With ``-hp`` naming ``Vocoder.Type: HiFiGAN`` the generator's weights are
read from the ``.npz`` that ``Vocoder.HiFiGAN.Weights`` names.
"""

from __future__ import annotations

import argparse
import functools
import pathlib
import time

import numpy as np
import torch

from multi_speaker_tts_tpu_torch import telemetry
from multi_speaker_tts_tpu_torch import text as text_frontend
from multi_speaker_tts_tpu_torch.audio import dsp, wav_io
from multi_speaker_tts_tpu_torch.checkpoints import load_compact
from multi_speaker_tts_tpu_torch.hparams import (
    Recursive_Parse,
    default_hparams,
    load_hyper_parameters,
    vocoder_type,
)
from multi_speaker_tts_tpu_torch.models.cbhg import CBHGHead
from multi_speaker_tts_tpu_torch.models.ge2e import GE2E
from multi_speaker_tts_tpu_torch.models.hifigan import HiFiGAN, read_weights
from multi_speaker_tts_tpu_torch.models.speaker import SpeakerLUT
from multi_speaker_tts_tpu_torch.models.tacotron import Tacotron
from multi_speaker_tts_tpu_torch.ops import stft_matmul
from multi_speaker_tts_tpu_torch.ops.numerics import compute_dtype_of
from multi_speaker_tts_tpu_torch.parallel import mesh as mesh_lib
from multi_speaker_tts_tpu_torch.text import PAD_ID
from multi_speaker_tts_tpu_torch.weights import load_into, params_from_jax, params_to_jax


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _decode_bucket(estimate: int, max_step: int, floor: int = 64) -> int:
    """Smallest pow2-style bucket >= estimate, in [floor, max_step]."""
    bucket = floor
    while bucket < min(estimate, max_step):
        bucket *= 2
    return min(bucket, max_step)


def resolve_device(device) -> torch.device:
    """``None`` means CUDA, and CUDA must be there; only an explicit
    ``"cpu"`` runs on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


@functools.lru_cache(maxsize=8)
def _mel_pinv(cfg, device: torch.device) -> torch.Tensor:
    """The filterbank's pseudo-inverse (n_fft//2 + 1, n_mels) on ``device``."""
    return torch.from_numpy(np.linalg.pinv(np.asarray(cfg.mel_basis))).to(device)


def _gl_magnitude(linear: torch.Tensor | None, mel_post: torch.Tensor, cfg) -> torch.Tensor:
    """Normalized linear spectrogram (or, for mel-only models, the mel
    through the filterbank pseudo-inverse) -> linear magnitude for
    Griffin-Lim."""
    if linear is None:
        basis = _mel_pinv(cfg, mel_post.device)
        S_db = dsp.denormalize(mel_post, cfg.min_level_db)
        return torch.clamp(dsp.db_to_amp(S_db + cfg.ref_level_db) @ basis.T, min=0.0)
    return dsp.db_to_amp(dsp.denormalize(linear, cfg.min_level_db) + cfg.ref_level_db)


def pcm16(wav: torch.Tensor) -> torch.Tensor:
    """Float waveform -> 16-bit PCM, clipped at full scale."""
    return torch.clamp(torch.round(wav * 32767.0), -32768.0, 32767.0).to(torch.int16)


_pcm16 = pcm16  # for methods whose ``pcm16`` argument hides the function


def _gl_vocode(linear, mel_post: torch.Tensor, cfg, as_pcm16: bool) -> torch.Tensor:
    """Magnitudes -> Griffin-Lim -> inverse preemphasis (-> PCM): the
    kernel / GEMM route when the hop divides n_fft, else the FFT route."""
    mag = _gl_magnitude(linear, mel_post, cfg)
    length = cfg.hop * (mag.shape[-2] - 1)
    gl = stft_matmul.griffin_lim_auto if cfg.n_fft % cfg.hop == 0 else dsp.griffin_lim
    wav = gl(mag ** cfg.power, cfg.n_fft, cfg.hop, cfg.griffin_lim_iter, length,
             momentum=cfg.griffin_lim_momentum)
    wav = dsp.inv_preemphasis(wav, cfg.preemphasis)
    return pcm16(wav) if as_pcm16 else wav


# ``Synthesizer(quantize=...)`` -> the ``hp.Decoder`` keys it switches on.
_QUANTIZE_MODES = {
    "int8": {"Quantize_Int8": True},  # weight-only int8 gates, plain loop
    "int8_pallas": {"Pallas_Decode": True},  # decode kernel, int8 gates
    "bf16_pallas": {"Pallas_Decode": "bf16"},  # decode kernel, bf16 gates
}


def prenet_mask_sampler(hp, device: torch.device, seed: int, batch: int):
    """``t -> [(batch, size) bool keep mask per prenet layer]``: step t's
    masks, drawn once, in step order, from a generator seeded with ``seed``
    and kept for the call, so that a repeated or out-of-order call (a row
    shard that decodes further than another) reads the same draws."""
    keep = 1.0 - float(hp.Decoder.Prenet.Dropout_Rate)
    sizes = list(hp.Decoder.Prenet.Sizes)
    generator = torch.Generator(device).manual_seed(seed)
    steps = []

    def masks(t: int):
        while len(steps) <= t:
            steps.append([torch.rand((batch, s), generator=generator, device=device) < keep
                          for s in sizes])
        return steps[t]

    return masks


class Synthesizer:
    """Text -> waveform with zero-shot speaker cloning, on one device.

    ``quantize`` picks the AR decode: None (the checkpoint's own
    ``Decoder.Quantize_Int8`` / ``Decoder.Pallas_Decode``, by default the
    plain loop in the compute dtype), ``"int8"``, ``"int8_pallas"`` or
    ``"bf16_pallas"``. ``mesh`` (:func:`..parallel.mesh.create_mesh`, a
    list of devices, which may repeat) holds one replica of the synthesizer
    a device for ``synthesize(sharded=True)``; ``device`` defaults to its
    first. ``vocoder_params``: the HiFi-GAN generator's folded f32 weights
    by the public module names, required where ``Vocoder.Type`` is
    ``HiFiGAN`` and refused otherwise; the generator runs on ``device``."""

    def __init__(self, hp, params, batch_stats, seed: int = 0, device=None,
                 quantize: str | None = None, mesh=None, vocoder_params=None):
        if quantize is not None:
            if quantize not in _QUANTIZE_MODES:
                raise ValueError(f"unknown quantize mode {quantize!r}")
            hp = hp.replace(Decoder=_QUANTIZE_MODES[quantize])
        if mesh is not None:
            mesh = mesh_lib.create_mesh(devices=mesh)
            device = mesh[0] if device is None else device
        self.device = resolve_device(device)
        self.hp = hp
        self.compute_dtype = compute_dtype_of(hp)
        self.dsp_cfg = dsp.DSPConfig.from_hp(hp)
        spk_type = hp.Speaker_Embedding.get("Type")
        if spk_type not in ("GE2E", "LUT", None):
            raise NotImplementedError(f"unknown Speaker_Embedding.Type {spk_type!r}")
        state = params_from_jax(params, batch_stats, hp)
        self.ge2e = self.speaker_lut = None
        if spk_type == "GE2E":
            self.ge2e = GE2E.from_hp(hp, self.compute_dtype)
            load_into(self.ge2e, state, "ge2e.")
            self.ge2e.to(self.device)
        elif spk_type == "LUT":
            self.speaker_lut = SpeakerLUT.from_hp(hp)
            load_into(self.speaker_lut, state, "speaker_lut.")
            self.speaker_lut.to(self.device)
        self.tacotron = Tacotron(hp, self.compute_dtype)
        load_into(self.tacotron, state, "tacotron.")
        self.tacotron.to(self.device)
        self.vocoder = None
        if vocoder_type(hp) == "HiFiGAN":
            if vocoder_params is None:
                raise ValueError("Vocoder.Type HiFiGAN: pass vocoder_params, the generator's "
                                 "weights (the CLIs read Vocoder.HiFiGAN.Weights)")
            self.vocoder = HiFiGAN.from_hp(hp, self.compute_dtype).load(vocoder_params)
            self.vocoder.to(self.device)
        elif vocoder_params is not None:
            raise ValueError("vocoder_params given, but Vocoder.Type is Griffin_Lim")
        self.mesh = mesh
        self._replicas = {} if mesh is None else mesh_lib.replicate(self.tacotron, mesh)
        self._replicas.setdefault(self.device, self.tacotron)
        self.seed = seed
        self.enroll_bucket_floor = 1 << 13
        self.last_decode_bucket: int | None = None
        # The distinct programs the JAX package would compile for the calls
        # made so far, by its own cache keys (its ``infer``, ``vocode`` and
        # ``stream`` keys): the port runs eagerly and compiles nothing, but a
        # server reports how many shapes its traffic has reached (``/stats``
        # ``compiled_programs``). Each key maps to 1.
        self.compile_counts: dict = {}

    @classmethod
    def from_compact(cls, path: str, hp=None, **kwargs) -> "Synthesizer":
        """Load an ``export_compact`` checkpoint; hp from its ``meta["hp"]``
        unless given."""
        params, batch_stats, meta = load_compact(path)
        if hp is None:
            if "hp" not in meta:
                raise ValueError(f"{path} carries no hp; pass one explicitly")
            hp = Recursive_Parse(meta["hp"])
        return cls(hp, params, batch_stats, **kwargs)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, hp=None, **kwargs) -> "Synthesizer":
        """The latest step of a training checkpoint directory (the port's
        ``train.checkpoints.CheckpointManager``); hp from the checkpoint
        unless given."""
        from multi_speaker_tts_tpu_torch.train.checkpoints import CheckpointManager

        state, step = CheckpointManager(checkpoint_dir).restore()
        if state is None:
            raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
        if hp is None:
            hp = Recursive_Parse(state["hp"]) if "hp" in state else default_hparams()
        print(f"loaded checkpoint step {step}")
        return cls.from_state(hp, state, **kwargs)

    @classmethod
    def from_state(cls, hp, state: dict, **kwargs) -> "Synthesizer":
        """From a trainer's ``checkpoint_state()``: its params and BatchNorm
        statistics by state key."""
        params, batch_stats = params_to_jax({**state["params"], **state["batch_stats"]}, hp)
        return cls(hp, params, batch_stats, **kwargs)

    @classmethod
    def from_path(cls, path: str, **kwargs) -> "Synthesizer":
        """A checkpoint directory (:meth:`from_checkpoint`) or a compact
        ``.msgpack`` file (:meth:`from_compact`)."""
        if pathlib.Path(path).is_dir():
            return cls.from_checkpoint(path, **kwargs)
        return cls.from_compact(path, **kwargs)

    # -- enroll --------------------------------------------------------------
    @torch.no_grad()
    def enroll(self, wavs) -> np.ndarray:
        """Reference wav(s) -> one unit-norm speaker embedding (E,): each wav
        is wrap-padded to a pow2 bucket (floored so one full GE2E window of
        signal exists), embedded over the windows inside its real frames,
        and the per-wav embeddings are averaged and renormalized."""
        if self.ge2e is None:
            raise ValueError("model has no GE2E speaker encoder")
        spk = self.hp.Speaker_Embedding.GE2E
        win_len, win_shift = spk.Window_Length, spk.Window_Shift
        hop = self.dsp_cfg.hop
        embs = []
        for wav in wavs if isinstance(wavs, (list, tuple)) else [wavs]:
            if isinstance(wav, (str, pathlib.Path)):
                wav, _ = wav_io.load_wav(wav, target_sr=self.hp.Sound.Sample_Rate)
            wav = np.asarray(wav, np.float32)
            true_frames = 1 + len(wav) // hop
            floor_pow = max(
                int(np.ceil(np.log2(max((win_len - 1) * hop, 2)))),
                int(np.ceil(np.log2(max(self.enroll_bucket_floor, 2)))),
            )
            L = 1 << max(int(np.ceil(np.log2(max(len(wav), 2)))), floor_pow)
            wav = np.pad(wav, (0, L - len(wav)), mode="wrap")
            w = torch.from_numpy(wav).to(self.device)[None]
            mel = dsp.melspectrogram_auto(w, self.dsp_cfg)
            embs.append(self.ge2e.embed_utterance(
                mel, win_len, win_shift,
                torch.tensor([true_frames], device=self.device),
            )[0])
        mean = torch.stack(embs).mean(dim=0)
        mean = mean / torch.clamp(torch.linalg.vector_norm(mean), min=1e-6)
        return mean.cpu().numpy()

    # -- synthesize ------------------------------------------------------------
    @torch.no_grad()
    def embed_speaker_ids(self, speaker_ids) -> np.ndarray:
        """Closed-set models (``Speaker_Embedding.Type: LUT``): ids -> (B, E)
        unit-norm embeddings."""
        if self.speaker_lut is None:
            raise ValueError("model has no speaker lookup table")
        ids = torch.as_tensor(np.atleast_1d(np.asarray(speaker_ids, np.int64)), device=self.device)
        return self.speaker_lut(ids).cpu().numpy()

    def _prenet_masks(self, batch: int):
        """Always-on prenet dropout: one (batch, size) bool keep mask per
        prenet layer per step, from a generator seeded with ``self.seed``
        for this call. As in the JAX package, whose every call starts from
        the same key, the masks differ from step to step and repeat from
        call to call: one request gives one answer."""
        return prenet_mask_sampler(self.hp, self.device, self.seed, batch)

    def _prepare(self, texts, speaker_embedding, speaker_ids, max_steps, n_shards: int = 1,
                 pad_batch: bool = True):
        """Tokens in a pow2 batch bucket (``pad_batch``; rounded up to a
        multiple of ``n_shards``; PAD rows inactive) and a 16-multiple token
        bucket; the decode bucket from the longest text; LUT speaker ids
        looked up in place of an embedding."""
        hp = self.hp
        sequences = [text_frontend.encode_text(t, hp) for t in texts]
        B = len(sequences)
        Bp = B
        if pad_batch:
            Bp = _round_up(1 << max(0, (B - 1).bit_length()), n_shards)
        elif B % n_shards:
            raise ValueError(f"pad_batch=False: {B} texts do not split over {n_shards} devices")
        longest = max(len(s) for s in sequences)
        if max_steps is None:
            per_token = int(hp.Decoder.get("Max_Frames_Per_Token", 12))
            max_steps = _decode_bucket(longest * per_token, hp.Decoder.Max_Step)
        S = _round_up(longest, 16)
        tokens = np.full((Bp, S), PAD_ID, np.int64)
        lengths = np.ones((Bp,), np.int64)
        for i, s in enumerate(sequences):
            tokens[i, :len(s)] = s
            lengths[i] = len(s)
        if speaker_ids is not None:
            speaker_embedding = self.embed_speaker_ids(speaker_ids)
        spk = None
        if self.tacotron.speaker_embedding_size:
            if speaker_embedding is None:
                raise ValueError("model is speaker-conditioned: pass an embedding")
            spk = np.asarray(speaker_embedding, np.float32)
            if spk.ndim == 1:
                spk = np.tile(spk[None], (Bp, 1))
            elif spk.shape[0] < Bp:  # pad rows reuse the first embedding
                spk = np.concatenate([spk, np.tile(spk[:1], (Bp - spk.shape[0], 1))])
            spk = torch.from_numpy(spk).to(self.device)
        active = np.zeros((Bp,), bool)
        active[:B] = True
        dev = self.device
        return (B, max_steps, torch.from_numpy(tokens).to(dev),
                torch.from_numpy(lengths).to(dev), spk, torch.from_numpy(active).to(dev))

    @torch.no_grad()
    def synthesize(self, texts: list[str], speaker_embedding=None,
                   max_steps: int | None = None, vocode: bool = True,
                   sharded: bool = False, speaker_ids=None, early_exit: bool = True,
                   pad_batch: bool = True, return_linear: bool = True,
                   pcm16: bool = False, split_vocode: bool = True,
                   return_device: bool = False) -> list[dict]:
        """Texts -> [{wav, mel, linear, alignment, mel_length}], the
        parameters in the JAX ``Synthesizer.synthesize`` order. With
        ``split_vocode`` (the default) Griffin-Lim runs at a pow2 bucket of
        the batch's longest decoded length; ``split_vocode=False`` vocodes
        the whole decode bucket, as the JAX package's fused program does
        (the wavs differ by Griffin-Lim's phase coupling into the padding).
        ``vocode=False`` returns no wav. ``linear`` is there for models
        with a linear head unless ``return_linear=False``; ``early_exit=False``
        runs the fixed-length decode. ``speaker_ids`` (LUT models) takes the
        place of ``speaker_embedding``.

        ``pad_batch`` (the default) rounds the batch up to a pow2 bucket
        with PAD rows (pre-stopped, sliced off); False runs the exact batch.
        ``sharded`` with a mesh splits the padded batch (a multiple of the
        mesh size) into contiguous row shards, one a device: each shard
        decodes on its device under its rows of the prenet masks drawn for
        the whole batch, and every shard is vocoded at the bucket of the
        whole batch's longest decoded length, so a row's output does not
        depend on the sharding (frames past each row's length are zeroed
        before the postnet, and every shard's head reads the same decode
        bucket). Without a mesh ``sharded`` changes nothing. The shards run
        one after another from this thread. ``return_device`` returns the
        raw output dict instead (``mel_post``, ``alignments``,
        ``mel_lengths``, ``linear``; with ``split_vocode=False`` and
        ``vocode`` also ``wav``), untrimmed, PAD rows included, on the
        synthesizer's device. Under ``early_exit`` the decode runs only the
        rows still decoding: a row's ``alignments`` past the chunk of steps
        it stopped in, and a PAD row's throughout, are zeros."""
        with telemetry.span("synth.call"):
            shards = self.mesh if sharded and self.mesh is not None else [self.device]
            n = len(shards)
            with telemetry.span("synth.prepare"):
                B, max_steps, tokens, lengths, spk, active = self._prepare(
                    texts, speaker_embedding, speaker_ids, max_steps, n, pad_batch)
                Bp = tokens.shape[0]
                self.last_decode_bucket = max_steps
                split = vocode and split_vocode
                self.compile_counts.setdefault(
                    ("infer", tokens.shape[1], Bp, max_steps, vocode and not split, sharded,
                     early_exit, True if split else return_linear, False if split else pcm16), 1)
                masks = self._prenet_masks(Bp)
                threshold = float(self.hp.Decoder.Stop_Threshold)
            outs = []
            for i, dev in enumerate(shards):
                rows = slice(i * (Bp // n), (i + 1) * (Bp // n))
                outs.append(self._replicas[dev].infer(
                    tokens[rows].to(dev), lengths[rows].to(dev),
                    None if spk is None else spk[rows].to(dev), max_steps, threshold,
                    active[rows].to(dev),
                    lambda t, rows=rows, dev=dev: [m[rows].to(dev) for m in masks(t)],
                    early_exit))
            if return_device:
                keys = ["mel_post", "alignments", "mel_lengths"]
                if "linear" in outs[0] and (split or return_linear):
                    keys.append("linear")
                out = {k: torch.cat([o[k].to(self.device) for o in outs]) for k in keys}
                if vocode and not split:
                    out["wav"] = torch.cat([self._vocode(o.get("linear"), o["mel_post"],
                                                         pcm16).to(self.device) for o in outs])
                return out
            mel_lengths = torch.cat([o["mel_lengths"].cpu() for o in outs]).numpy()
            r = int(self.hp.Decoder.get("N_Frames_Per_Step", 1))
            Tb = _decode_bucket(max(int(mel_lengths.max()), r), max_steps)
            if split:
                self.compile_counts.setdefault(
                    ("vocode", tokens.shape[1], Bp, Tb, return_linear, pcm16, sharded), 1)
            steps = max(-(-Tb // r), 1)
            parts = {"mel": [], "linear": [], "wav": [], "alignment": []}
            for o in outs:
                mel_post = o["mel_post"][:, :Tb]
                linear = o["linear"][:, :Tb] if "linear" in o else None
                if vocode:
                    lin_v, mel_v = ((linear, mel_post) if split_vocode
                                    else (o.get("linear"), o["mel_post"]))
                    with telemetry.span("synth.vocode"):
                        parts["wav"].append(self._vocode(lin_v, mel_v, pcm16).cpu())
                with telemetry.span("synth.return"):
                    parts["mel"].append(mel_post.cpu())
                    if return_linear and linear is not None:
                        parts["linear"].append(linear.cpu())
                    parts["alignment"].append(o["alignments"][:, :steps].cpu())
            with telemetry.span("synth.return"):
                joined = {k: torch.cat(v).numpy() for k, v in parts.items() if v}
                hop = self.dsp_cfg.hop
                results = []
                for i in range(B):
                    T = int(mel_lengths[i])
                    item = {
                        "mel": joined["mel"][i, :T],
                        "alignment": joined["alignment"][i, :max(-(-T // r), 1)],
                        "mel_length": T,
                    }
                    if "wav" in joined:
                        item["wav"] = joined["wav"][i, :max(T - 1, 1) * hop]
                    if "linear" in joined:
                        item["linear"] = joined["linear"][i, :T]
                    results.append(item)
            return results

    def _vocode(self, linear, mel_post: torch.Tensor, as_pcm16: bool) -> torch.Tensor:
        """A shard's vocoder stage: Griffin-Lim (:func:`_gl_vocode`, ``hop``
        x (frames - 1) samples a row, on the shard's device) or the HiFi-GAN
        generator on the postnet's mel (``hop`` x frames samples a row, on
        ``self.device``; no inverse preemphasis: its output is the
        waveform)."""
        if self.vocoder is None:
            return _gl_vocode(linear, mel_post, self.dsp_cfg, as_pcm16)
        wav = self.vocoder(mel_post.to(self.device))
        return pcm16(wav) if as_pcm16 else wav

    # -- streaming synthesis ----------------------------------------------------
    @torch.no_grad()
    def stream(self, texts: list[str], speaker_embedding=None, speaker_ids=None,
               max_steps: int | None = None, segment_steps: int = 16, gl_context: int = 12,
               pcm16: bool = False, return_mel: bool = False, gl_warm_start: bool = False):
        """Streaming synthesis: yields waveform chunks as decoding goes on.

        The decode runs in segments of ``segment_steps`` AR steps; each
        block of E = segment_steps * r frames is emitted one segment later,
        when the postnet and the Conv head see its whole receptive field on
        a window with explicit halos (PAD_L = G + Q + P frames left, PAD_R =
        Gr + Q + P right, G = ``gl_context``, Q / P the head's and the
        postnet's conv halos, Gr = n_fft/hop - 1) and a boundary mask: the
        emitted mel equals the batched ``synthesize`` mel under the same
        prenet masks. Griffin-Lim runs on the Wf = G + E + Gr frames around
        the block (frames outside a row's decoded length forced to the
        silence floor), and a raised-linear crossfade over Gr - 1 frames
        joins it to the previous window's tail: the one approximation
        against batch vocoding. ``gl_warm_start`` starts each window's
        Griffin-Lim from the previous window's converged audio over the
        overlap (``griffin_lim_matmul(init_head=...)``, the GEMM route).

        Yields {"wav_chunk": (B, E*hop) f32 (int16 with ``pcm16``),
        "frame_offset", "mel_lengths": (B,) decoded frames so far, "done"}
        and with ``return_mel`` the block's "mel_chunk" (B, E, mel). A CBHG
        head raises ``NotImplementedError`` (its bidirectional GRU needs the
        whole sequence); a segment shorter than the right halo raises
        ``ValueError``. ``speaker_ids`` (LUT models) takes the place of
        ``speaker_embedding``."""
        hp = self.hp
        r = int(hp.Decoder.get("N_Frames_Per_Step", 1))
        taco = self.tacotron
        if isinstance(taco.linear_head, CBHGHead):
            raise NotImplementedError(
                "streaming requires a causal-window linear head: the CBHG head's "
                "bidirectional GRU needs the full sequence (use Linear_Head.Type: Conv, "
                "or a mel-only model)")
        if self.vocoder is not None:
            raise NotImplementedError(
                "streaming vocodes windows with Griffin-Lim: the HiFi-GAN generator has no "
                "windowed route (use synthesize, or Vocoder.Type: Griffin_Lim)")
        cfg = self.dsp_cfg
        K, G = segment_steps, gl_context
        E = K * r
        # Conv halos: each conv of kernel size k reaches k // 2 frames aside.
        P, Q = (0 if m is None else sum(c.weight.shape[-1] // 2 for c in m.convs)
                for m in (taco.postnet, taco.linear_head))
        Gr = cfg.n_fft // cfg.hop - 1
        if E < Gr + Q + P:
            raise ValueError(
                f"segment too short for exact streaming: {K} steps = {E} frames < "
                f"right-context need {Gr + Q + P} (postnet {P} + linear {Q} + vocoder "
                f"{Gr} frames); raise segment_steps")
        B, max_steps, tokens, lengths, spk, active = self._prepare(
            texts, speaker_embedding, speaker_ids, max_steps)
        Bp = tokens.shape[0]
        cap_steps = max(max_steps // r, 1)
        self.last_decode_bucket = max_steps
        n_segs = _round_up(max(cap_steps, K), K) // K
        self.compile_counts.setdefault(
            ("stream", tokens.shape[1], Bp, n_segs * K, K, cap_steps, G, pcm16, gl_warm_start), 1)
        bucket_frames = n_segs * E
        PAD_L, PAD_R = G + Q + P, Gr + Q + P
        Wmel, Wf = PAD_L + E + PAD_R, G + E + Gr
        xf = max(Gr - 1, 0) * cfg.hop
        stop_threshold = float(hp.Decoder.Stop_Threshold)
        dev = self.device
        floor = dsp.db_to_amp(dsp.denormalize(torch.zeros((), device=dev), cfg.min_level_db)
                              + cfg.ref_level_db)
        ramp = torch.arange(xf, device=dev, dtype=torch.float32)[None, :] / max(xf, 1)

        prenet_masks = self._prenet_masks(Bp)
        st = taco.infer_stream_init(tokens, lengths, spk, active)
        buf = torch.zeros((Bp, PAD_L + bucket_frames + PAD_R, taco.mel_dim), device=dev)
        tails = {"x": torch.zeros((Bp, xf), device=dev),
                 "w": torch.zeros((Bp, max(G + Gr - 1, 0) * cfg.hop), device=dev)}

        def decode_segment():
            nonlocal st
            t0 = st["t0"]
            mel_seg, _, st = taco.infer_stream_segment(st, K, stop_threshold,
                                                       prenet_masks, cap_steps)
            buf[:, PAD_L + t0 * r:PAD_L + t0 * r + E] = mel_seg

        def emit(a: int) -> dict:
            """Frames [a, a + E): postnet and head on the exact-halo window
            (buffer index = frame + PAD_L), windowed Griffin-Lim, crossfade."""
            win = buf[:, a:a + Wmel]
            widx = (a - PAD_L) + torch.arange(Wmel, device=dev)
            bm = ((widx >= 0) & (widx < bucket_frames)).float()[None].expand(Bp, Wmel)
            mel_post_w, lin_w = taco.stream_postnet_linear(win, bm)
            mag = _gl_magnitude(lin_w, mel_post_w, cfg)[:, Q + P:Q + P + Wf]
            fidx = (a - G) + torch.arange(Wf, device=dev)
            valid = (fidx[None, :] >= 0) & (fidx[None, :] < (st["lengths"] * r)[:, None])
            mag = torch.where(valid[..., None], mag, floor)
            if gl_warm_start:
                gl_win = stft_matmul.griffin_lim_matmul(
                    mag ** cfg.power, cfg.n_fft, cfg.hop, cfg.griffin_lim_iter,
                    cfg.hop * (Wf - 1), momentum=cfg.griffin_lim_momentum,
                    init_head=tails["w"], init_head_gate=a > 0)
                tails["w"] = gl_win[:, E * cfg.hop:E * cfg.hop + tails["w"].shape[-1]]
            else:
                gl_win = stft_matmul.griffin_lim_auto(
                    mag ** cfg.power, cfg.n_fft, cfg.hop, cfg.griffin_lim_iter,
                    cfg.hop * (Wf - 1), momentum=cfg.griffin_lim_momentum)
            wav_win = dsp.inv_preemphasis(gl_win, cfg.preemphasis)
            chunk = wav_win[:, G * cfg.hop:(G + E) * cfg.hop]
            if xf > 0:
                head = chunk[:, :xf]
                if a > 0:  # the first block has no predecessor
                    head = (1.0 - ramp) * tails["x"] + ramp * head
                chunk = torch.cat([head, chunk[:, xf:]], dim=-1)
            tails["x"] = wav_win[:, (G + E) * cfg.hop:(G + E) * cfg.hop + xf]
            if pcm16:
                chunk = _pcm16(chunk)
            item = {"wav_chunk": chunk[:B].cpu().numpy(),
                    "mel_lengths": (st["lengths"][:B] * r).cpu().numpy()}
            if return_mel:
                bidx = a + torch.arange(E, device=dev)
                bvalid = (bidx[None, :] < (st["lengths"] * r)[:, None]).float()
                block = mel_post_w[:, PAD_L:PAD_L + E] * bvalid[..., None]
                item["mel_chunk"] = block[:B].cpu().numpy()
            return item

        decode_segment()
        for i in range(1, n_segs):
            a = st["t0"] * r - E  # the previous segment's block
            decode_segment()
            item = emit(a)
            item.update(frame_offset=(i - 1) * E, done=False)
            yield item
            if bool(st["stopped"].all()):
                break
        a = st["t0"] * r - E  # the final decoded block
        item = emit(a)
        item.update(frame_offset=a, done=True)
        yield item


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="TTS inference / zero-shot cloning")
    parser.add_argument("-checkpoint", required=True,
                        help=".msgpack compact checkpoint (export_compact) or a "
                             "training checkpoint directory")
    parser.add_argument("-hp", "--hyper_parameters", default=None,
                        help="hyper-parameters (YAML, needs pyyaml, or JSON) in place "
                             "of the checkpoint's own")
    parser.add_argument("-text", action="append", default=[])
    parser.add_argument("-text_file", default=None,
                        help="file with one sentence per line")
    parser.add_argument("-ref", action="append", default=[],
                        help="enrollment wav(s) for zero-shot cloning (GE2E)")
    parser.add_argument("-speaker_id", type=int, default=None,
                        help="speaker index for LUT models")
    parser.add_argument("-out", default="./inference")
    parser.add_argument("-max_steps", type=int, default=None)
    parser.add_argument("-stream", action="store_true",
                        help="stream chunks to <out>/utt_<i>.wav as they "
                             "decode (Synthesizer.stream); prints per-chunk "
                             "timing instead of alignments")
    parser.add_argument("-quantize", default=None, choices=["int8", "int8_pallas", "bf16_pallas"],
                        help="the AR decode: weight-only int8, or the decode "
                             "kernel with int8 or bf16 gates")
    parser.add_argument("-device", default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    hp = load_hyper_parameters(args.hyper_parameters) if args.hyper_parameters else None

    texts = list(args.text)
    if args.text_file:
        with open(args.text_file, encoding="utf-8") as f:
            texts += [line.strip() for line in f if line.strip()]
    if not texts:
        parser.error("pass -text and/or -text_file")
    try:
        synth = Synthesizer.from_path(args.checkpoint, hp=hp, quantize=args.quantize,
                                      device=args.device, vocoder_params=read_weights(hp))
    except FileNotFoundError as e:  # no such file, or a directory without a checkpoint
        parser.error(f"-checkpoint {args.checkpoint!r}: {e}")
    hp = synth.hp
    spk_type = hp.Speaker_Embedding.get("Type")
    if spk_type == "GE2E" and not args.ref:
        parser.error(
            "this model is speaker-conditioned: pass at least one enrollment "
            "wav with -ref"
        )
    if spk_type == "LUT" and args.speaker_id is None:
        parser.error("this model uses a speaker lookup table: pass -speaker_id")
    spk = synth.enroll(args.ref) if args.ref else None
    ids = None if args.speaker_id is None else [args.speaker_id] * len(texts)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.stream:
        t0 = time.perf_counter()
        parts, lengths = [], None
        for chunk in synth.stream(texts, spk, max_steps=args.max_steps, speaker_ids=ids):
            parts.append(chunk["wav_chunk"])
            lengths = chunk["mel_lengths"]
            print(f"chunk at {(time.perf_counter() - t0) * 1e3:7.1f} ms: "
                  f"frames {chunk['frame_offset']}.."
                  f"{chunk['frame_offset'] + chunk['wav_chunk'].shape[1] // hp.Sound.Frame_Shift}")
        wav = np.concatenate(parts, axis=1)
        for i in range(len(texts)):
            n = max(int(lengths[i]) - 1, 1) * hp.Sound.Frame_Shift
            wav_io.save_wav(out_dir / f"utt_{i}.wav", wav[i, :n], hp.Sound.Sample_Rate)
            print(f"wrote {out_dir}/utt_{i}.wav ({int(lengths[i])} frames, streamed)")
        return

    results = synth.synthesize(texts, spk, max_steps=args.max_steps, speaker_ids=ids)
    for i, item in enumerate(results):
        wav_io.save_wav(out_dir / f"utt_{i}.wav", item["wav"], hp.Sound.Sample_Rate)
        np.save(out_dir / f"utt_{i}_mel.npy", item["mel"])
        np.save(out_dir / f"utt_{i}_alignment.npy", item["alignment"])
        _save_alignment_plot(
            out_dir / f"utt_{i}_alignment.png", item["alignment"], item["mel_length"]
        )
        print(f"wrote {out_dir}/utt_{i}.wav ({item['mel_length']} frames)")


def _save_alignment_plot(path, alignment: np.ndarray, mel_length: int) -> None:
    """Attention-alignment image, the reference's de-facto health metric.
    Skipped where matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.imshow(
        alignment[:mel_length].T, aspect="auto", origin="lower",
        interpolation="none", cmap="viridis",
    )
    ax.set_xlabel("decoder step")
    ax.set_ylabel("encoder position")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


if __name__ == "__main__":
    main()
