"""Tacotron-style synthesizer (port of ``multi_speaker_tts_tpu.models.tacotron``).

Text encoder (embedding -> conv/BN/ReLU stack -> BiLSTM), SV2TTS speaker
concatenation onto the memory, the decoder, the postnet, and the mel ->
linear head (``Linear_Head``: the CBHG of :mod:`.cbhg` or the Conv stack
:class:`LinearHead`).

Two paths share one parameter set, as in the JAX module:
- :meth:`Tacotron.infer`, serving under ``torch.no_grad()``: the stop-aware
  early-exit AR decoder (:mod:`..ops.decoder_scan`; under
  ``Decoder.Pallas_Decode`` its chunk body is the K-step kernel of
  :mod:`..ops.decode_kernel`), the masked postnet, the head;
- :meth:`Tacotron.forward`, the teacher-forced pass of training and
  evaluation: the prenet once over the shifted teacher frames, the
  teacher-forced scan with its hand-written backward
  (:func:`..ops.decoder_scan.decoder_tf_scan`, an autograd Function), the
  frame and stop projections hoisted after it, the postnet and the head;
  ``train=True`` switches the BatchNorms to batch statistics and the conv
  dropouts on (their masks and the prenet's from the caller's generator);
- streaming (:meth:`Tacotron.infer_stream_init`,
  :meth:`Tacotron.infer_stream_segment`, :meth:`Tacotron.stream_postnet_linear`):
  the decoder's segment mode runs K AR steps from explicit state, and the
  postnet and Conv head run on windows with a boundary mask, so that the
  emitted frames equal the batched ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multi_speaker_tts_tpu_torch import telemetry
from multi_speaker_tts_tpu_torch.audio.dsp import log_dispatch
from multi_speaker_tts_tpu_torch.models.cbhg import CBHGHead
from multi_speaker_tts_tpu_torch.models.layers import (
    BiLSTM,
    ConvBNBlock,
    Dense,
    LSTMWeights,
    prenet_apply,
    prenet_step,
    weight,
)
from multi_speaker_tts_tpu_torch.ops import decode_kernel
from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan
from multi_speaker_tts_tpu_torch.ops.numerics import rounded
from multi_speaker_tts_tpu_torch.parallel import multihost
from multi_speaker_tts_tpu_torch.text import vocab_size as text_vocab_size


class TextEncoder(nn.Module):
    def __init__(self, vocab: int, embedding_size: int, conv_stacks: int,
                 conv_channels: int, conv_kernel_size: int, lstm_size: int,
                 conv_dropout: float = 0.0):
        super().__init__()
        self.embedding = weight(vocab, embedding_size)
        self.convs = nn.ModuleList(
            ConvBNBlock(embedding_size if i == 0 else conv_channels,
                        conv_channels, conv_kernel_size, "relu", conv_dropout)
            for i in range(conv_stacks)
        )
        self.bilstm = BiLSTM(conv_channels, lstm_size)

    def forward(self, tokens: torch.Tensor, compute_dtype, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = F.embedding(tokens, self.embedding)
        for conv in self.convs:
            x = conv(x, compute_dtype, train, generator)
        return self.bilstm(x.float(), compute_dtype)


class AttentionWeights(nn.Module):
    def __init__(self, query_size: int, attention_size: int, conv_channels: int,
                 conv_kernel: int):
        super().__init__()
        self.wq = weight(query_size, attention_size)
        self.conv_kernel = weight(conv_kernel, 2, conv_channels)
        self.wloc = weight(conv_channels, attention_size)
        self.v = weight(attention_size, 1)

    @property
    def params(self) -> dscan.AttentionParams:
        return dscan.AttentionParams(self.wq, self.conv_kernel, self.wloc, self.v)


class Decoder(nn.Module):
    def __init__(self, mel_dim: int, memory_size: int, prenet_sizes,
                 prenet_dropout: float, attention_size: int,
                 attention_conv_channels: int, attention_conv_kernel: int,
                 lstm_size: int, lstm_stacks: int, n_frames_per_step: int,
                 early_exit_chunk: int = 16, quantize_int8: bool = False,
                 pallas_decode: bool | str = False):
        super().__init__()
        self.mel_dim = mel_dim
        self.r = n_frames_per_step
        self.prenet_dropout = float(prenet_dropout)
        self.early_exit_chunk = early_exit_chunk
        # Serving knobs of the AR loop (``Decoder.Quantize_Int8`` /
        # ``Decoder.Pallas_Decode``): weight-only int8 gates in the plain
        # loop; the K-step decode kernel, True / "int8" or "bf16".
        self.quantize_int8 = bool(quantize_int8)
        self.pallas_decode = pallas_decode
        self.memory_layer = Dense(memory_size, attention_size, use_bias=False)
        sizes = [mel_dim, *prenet_sizes]
        self.prenet = nn.ModuleList(Dense(a, b) for a, b in zip(sizes, sizes[1:]))
        self.lstm = nn.ModuleList(
            LSTMWeights((sizes[-1] if i == 0 else lstm_size) + memory_size, lstm_size)
            for i in range(lstm_stacks)
        )
        self.attention = AttentionWeights(lstm_size, attention_size,
                                          attention_conv_channels,
                                          attention_conv_kernel)
        x_dim = lstm_size + memory_size
        self.frame_proj = Dense(x_dim, mel_dim * n_frames_per_step)
        self.stop_proj = Dense(x_dim, 1)

    def params(self) -> dscan.DecoderParams:
        return dscan.DecoderParams(
            lstm=tuple(m.params for m in self.lstm),
            attention=self.attention.params,
            frame_proj=(self.frame_proj.kernel, self.frame_proj.bias),
            stop_proj=(self.stop_proj.kernel, self.stop_proj.bias),
        )

    def _ar_setup(self, memory, prenet_masks, compute_dtype):
        """The memory keys and the AR decode's chunk body, the one place the
        route is chosen: under ``Pallas_Decode`` the decode kernel's
        (:func:`..ops.decode_kernel.kernel_body`), else the plain loop's
        (:func:`..ops.decoder_scan.plain_body`, int8 gates under
        ``Quantize_Int8``), the prenet at global step t taking its keep
        masks from ``prenet_masks(t)``. Where the kernel's gate and the
        reference's both refuse (``decode_kernel.plain_reason``: past the
        kernel's limit on memory positions; on the card, bf16 past H 2048 on
        an H100, whose fused weights pass the reference's 80 MB), the plain
        loop's weights on the tensors' device instead, printing one
        ``[dispatch] decode -> plain`` line a process on the card."""
        keys = self.memory_layer(memory.float())
        ws = [(d.kernel, d.bias) for d in self.prenet]
        p = self.params()
        quantized = self.pallas_decode != "bf16"
        plain = (decode_kernel.plain_reason(p, [w.shape[1] for w, _ in ws], memory.shape[-1],
                                            memory.shape[1], self.mel_dim, quantized,
                                            decode_kernel.card_limits(memory.device),
                                            memory.is_cuda)
                 if self.pallas_decode else None)  # why the plain loop runs instead
        if self.pallas_decode and plain is None:
            # Every other refusal (where the reference launches its kernel)
            # raises at the launch on the card: no quiet fall-back.
            bundle = decode_kernel.prepare_bundle(p, ws, quantize=quantized)
            return keys, decode_kernel.kernel_body(bundle, prenet_masks, self.mel_dim, self.r,
                                                   self.prenet_dropout)
        if plain is not None and memory.is_cuda:
            log_dispatch("decode", "plain", plain)
        fused = (dscan.quantize_fused(p) if self.quantize_int8
                 else dscan.fused_weights(p.lstm, compute_dtype))
        return keys, dscan.plain_body(p, fused, prenet_step(ws, self.prenet_dropout, prenet_masks),
                                      self.mel_dim, compute_dtype)

    def infer(self, memory, mask, max_steps: int, stop_threshold: float,
              stopped_init, prenet_masks, compute_dtype, early_exit: bool = True):
        """AR decode -> (mel (B, n_steps*r, mel), stop logits (B, n_steps),
        aligns (B, n_steps, S), decoded steps (B,) or None). The early-exit
        loop knows each row's decoded steps; the fixed-length scan
        (``early_exit=False``) returns None and the caller derives them from
        the stop logits."""
        B = memory.shape[0]
        n_steps = max_steps // self.r
        keys, body = self._ar_setup(memory, prenet_masks, compute_dtype)
        args = (self.params(), keys, memory.float(), mask, n_steps)
        if early_exit:
            frames, stops, aligns, lengths = dscan.decoder_ar_early_exit(
                *args, stop_threshold, body, self.mel_dim, stopped_init=stopped_init,
                chunk=self.early_exit_chunk)
        else:
            lengths = None
            frames, stops, aligns = dscan.decoder_ar_scan(*args, body, self.mel_dim,
                                                          chunk=self.early_exit_chunk)
        mel = frames.transpose(0, 1).reshape(B, n_steps * self.r, self.mel_dim)
        return mel, stops.transpose(0, 1), aligns.transpose(0, 1), lengths

    def segment(self, memory, mask, state, n_steps: int, stop_threshold: float,
                prenet_masks, compute_dtype):
        """The streaming mode. ``state == "init"`` -> the zero decode state
        (carry, prev frame). A state dict {carry, prev, t0, stopped,
        lengths} -> ``n_steps`` AR steps from it through the chunk body of
        :meth:`_ar_setup`, the prenet masks drawn at the global step t0 + i:
        (mel (B, n_steps*r, mel), stop logits (B, n_steps), aligns (B,
        n_steps, S), {carry, prev, stopped, lengths})."""
        B = memory.shape[0]
        if isinstance(state, str):
            if state != "init":
                raise ValueError(f"unknown segment state {state!r}")
            carry = dscan.initial_carry(B, memory.float(), len(self.lstm),
                                        self.lstm[0].w_hh.shape[0])
            return carry, memory.new_zeros((B, self.mel_dim), dtype=torch.float32)
        keys, body = self._ar_setup(memory, prenet_masks, compute_dtype)
        carry, prev, stopped, lengths, f_k, s_k, w_k = body(
            keys, memory.float(), mask, state["carry"], state["prev"], state["t0"],
            state["stopped"], state["lengths"], n_steps, stop_threshold)
        mel = f_k.transpose(0, 1).reshape(B, n_steps * self.r, self.mel_dim)
        return mel, s_k.transpose(0, 1), w_k.transpose(0, 1), {
            "carry": carry, "prev": prev, "stopped": stopped, "lengths": lengths}

    def teacher_forced(self, memory, mask, mels, keep_masks, compute_dtype):
        """Teacher-forced decode over (B, T, mel) targets, T a multiple of r
        -> (mel (B, T, mel), stop logits (B, T/r), aligns (B, T/r, S)).
        Step t reads the last frame of group t-1 (a zero GO frame first);
        the prenet runs once over the whole sequence (``keep_masks``: one
        (B, T/r, size) bool mask per layer, or None when its dropout is 0);
        the frame and stop projections run once after the scan, in the
        compute dtype with f32 sums."""
        B, T, _ = mels.shape
        if T % self.r:
            raise ValueError(f"mel length {T} is not a multiple of r = {self.r}")
        group_last = mels[:, self.r - 1::self.r, :]
        inputs = torch.cat([mels.new_zeros((B, 1, self.mel_dim)), group_last[:, :-1]], dim=1)
        ws = [(d.kernel, d.bias) for d in self.prenet]
        pre_seq = prenet_apply(ws, inputs.float(), self.prenet_dropout, keep_masks)
        keys = self.memory_layer(memory.float())
        p = self.params()
        xs, aligns = dscan.decoder_tf_scan(p, pre_seq.transpose(0, 1), keys, memory.float(),
                                           mask, compute_dtype)
        xr = rounded(xs, compute_dtype)
        frames = xr @ rounded(p.frame_proj[0], compute_dtype) + p.frame_proj[1]
        stops = (xr @ rounded(p.stop_proj[0], compute_dtype) + p.stop_proj[1])[..., 0]
        mel = frames.transpose(0, 1).reshape(B, T, self.mel_dim)
        return mel, stops.transpose(0, 1), aligns.transpose(0, 1)


class Postnet(nn.Module):
    """Conv(tanh) stack whose output is a residual on the mel."""

    def __init__(self, mel_dim: int, conv_stacks: int, conv_channels: int,
                 conv_kernel_size: int, dropout_rate: float = 0.0):
        super().__init__()
        chans = [mel_dim] + [conv_channels] * (conv_stacks - 1) + [mel_dim]
        self.convs = nn.ModuleList(
            ConvBNBlock(a, b, conv_kernel_size,
                        "none" if i == conv_stacks - 1 else "tanh", dropout_rate)
            for i, (a, b) in enumerate(zip(chans, chans[1:]))
        )

    def forward(self, mel: torch.Tensor, compute_dtype, train: bool = False,
                generator: torch.Generator | None = None,
                boundary_mask: torch.Tensor | None = None) -> torch.Tensor:
        """``boundary_mask`` (B, T): 1 inside the sequence array, 0 where a
        streaming window reaches past it (where the batched convs see SAME
        padding zeros); applied before every conv, as in the JAX module."""
        x = mel
        for conv in self.convs:
            if boundary_mask is not None:
                x = x * boundary_mask[..., None]
            x = conv(x, compute_dtype, train, generator)
        return x.float()


class LinearHead(nn.Module):
    """Mel -> linear spectrogram by a Conv(relu) stack and a projection that
    runs in the compute dtype (the ``Linear_Head.Type: Conv`` variant)."""

    def __init__(self, mel_dim: int, spect_dim: int, conv_stacks: int = 2,
                 conv_channels: int = 512, conv_kernel_size: int = 5,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvBNBlock(mel_dim if i == 0 else conv_channels, conv_channels,
                        conv_kernel_size, "relu", dropout_rate)
            for i in range(conv_stacks)
        )
        self.projection = Dense(conv_channels, spect_dim)

    def forward(self, mel: torch.Tensor, compute_dtype, train: bool = False,
                generator: torch.Generator | None = None,
                boundary_mask: torch.Tensor | None = None) -> torch.Tensor:
        """``boundary_mask``: as :meth:`Postnet.forward`, before each conv."""
        x = mel
        for conv in self.convs:
            if boundary_mask is not None:
                x = x * boundary_mask[..., None]
            x = conv(x, compute_dtype, train, generator)
        y = rounded(x, compute_dtype) @ rounded(self.projection.kernel, compute_dtype)
        return rounded(rounded(y, compute_dtype)
                       + rounded(self.projection.bias, compute_dtype), compute_dtype)


def linear_head_from_hp(hp):
    """The head ``hp.Linear_Head`` asks for, or None for a mel-only model."""
    lh = hp.get("Linear_Head")
    if lh is None or not lh.Use:
        return None
    mel_dim, spect_dim = hp.Sound.Mel_Dim, hp.Sound.Spectrogram_Dim
    if lh.get("Type", "Conv") == "CBHG":
        cb = lh.CBHG
        return CBHGHead(
            mel_dim, spect_dim, gru_size=cb.GRU_Size, bank_k=cb.Bank_K,
            bank_channels=cb.Bank_Channels, projection_channels=cb.Projection_Channels,
            highway_layers=cb.Highway.Layers, highway_size=cb.Highway.Size,
        )
    return LinearHead(mel_dim, spect_dim, lh.Conv.Stacks, lh.Conv.Channels,
                      lh.Conv.Kernel_Size, lh.Conv.get("Dropout_Rate", 0.0))


class Tacotron(nn.Module):
    def __init__(self, hp, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.mel_dim = hp.Sound.Mel_Dim
        self.speaker_embedding_size = (
            hp.Speaker_Embedding.Embedding_Size
            if hp.Speaker_Embedding.get("Type") else 0
        )
        enc = hp.Encoder
        self.encoder = TextEncoder(
            text_vocab_size(hp), enc.Embedding_Size, enc.Conv.Stacks,
            enc.Conv.Channels, enc.Conv.Kernel_Size, enc.LSTM_Size,
            enc.Conv.get("Dropout_Rate", 0.0),
        )
        dec = hp.Decoder
        self.decoder = Decoder(
            self.mel_dim, enc.LSTM_Size + self.speaker_embedding_size,
            tuple(dec.Prenet.Sizes), dec.Prenet.Dropout_Rate,
            dec.Attention.Size, dec.Attention.Conv.Channels,
            dec.Attention.Conv.Kernel_Size, dec.LSTM.Sizes, dec.LSTM.Stacks,
            dec.get("N_Frames_Per_Step", 1), dec.get("Early_Exit_Chunk", 16),
            dec.get("Quantize_Int8", False), dec.get("Pallas_Decode", False),
        )
        post = hp.Postnet.Conv
        self.postnet = Postnet(self.mel_dim, post.Stacks, post.Channels,
                               post.Kernel_Size, post.get("Dropout_Rate", 0.0))
        self.linear_head = linear_head_from_hp(hp)

    def build_memory(self, tokens, token_lengths, speaker_embedding, train: bool = False,
                     generator: torch.Generator | None = None):
        enc = self.encoder(tokens, self.compute_dtype, train, generator)
        if self.speaker_embedding_size:
            if speaker_embedding is None:
                raise ValueError("model is speaker-conditioned: pass an embedding")
            spk = speaker_embedding[:, None, :].float().expand(
                *enc.shape[:2], self.speaker_embedding_size)
            enc = torch.cat([enc, spk], dim=-1)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        mask = (pos[None, :] < token_lengths[:, None]).float()
        return enc, mask

    def forward(self, tokens, token_lengths, mels, speaker_embedding=None,
                train: bool = False, generator: torch.Generator | None = None,
                prenet_masks=None) -> dict:
        """Teacher-forced pass (training and evaluation) -> mel_pre,
        mel_post, stop_logits, alignments (and linear with a head). The
        prenet's dropout is always on; its masks are ``prenet_masks`` (one
        (B, T/r, size) bool tensor per layer) or drawn from ``generator``
        (at the global batch's shape in a data-parallel run).
        ``train`` switches the BatchNorms to batch statistics (updating the
        running ones) and the conv dropouts on."""
        memory, mask = self.build_memory(tokens, token_lengths, speaker_embedding, train,
                                         generator)
        dec = self.decoder
        if prenet_masks is None and dec.prenet_dropout > 0.0:
            shape = (mels.shape[0], mels.shape[1] // dec.r)
            prenet_masks = [
                multihost.global_rand((*shape, d.kernel.shape[1]), generator,
                                      mels.device) < 1.0 - dec.prenet_dropout
                for d in dec.prenet
            ]
        mel_pre, stops, aligns = dec.teacher_forced(memory, mask, mels, prenet_masks,
                                                    self.compute_dtype)
        mel_post = mel_pre + self.postnet(mel_pre, self.compute_dtype, train, generator)
        out = {"mel_pre": mel_pre, "mel_post": mel_post, "stop_logits": stops,
               "alignments": aligns}
        if self.linear_head is not None:
            out["linear"] = self.linear_head(mel_post, self.compute_dtype, train, generator)
        return out

    @torch.no_grad()
    def infer(self, tokens, token_lengths, speaker_embedding, max_steps: int,
              stop_threshold: float, active_rows=None, prenet_masks=None,
              early_exit: bool = True) -> dict:
        """AR decode + masked postnet (+ linear head). ``early_exit`` runs
        the stop-aware chunked loop; False the fixed-length scan, with each
        row's length taken from its first stop logit over the threshold. PAD
        rows (``active_rows`` False) start stopped; frames past each decoded
        length are zeroed before the postnet. The early-exit loop decodes a
        row no further than the chunk it stopped in: past it the row's stop
        logits are -1e4 and its alignments zeros. The linear head sees the
        postnet's output over the whole decode bucket (not re-masked) and
        its result is masked afterwards."""
        with telemetry.span("synth.encoder"):
            memory, mask = self.build_memory(tokens, token_lengths, speaker_embedding)
        stopped_init = None if active_rows is None else ~active_rows.to(torch.bool)
        with telemetry.span("synth.decode"):
            mel_pre, stops, aligns, lengths_steps = self.decoder.infer(
                memory, mask, max_steps, stop_threshold, stopped_init, prenet_masks,
                self.compute_dtype, early_exit,
            )
        if lengths_steps is None:
            flags = torch.sigmoid(stops.float()) > stop_threshold  # (B, n_steps)
            first = torch.argmax(flags.to(torch.int32), dim=1) + 1
            lengths_steps = torch.where(flags.any(dim=1), first,
                                        torch.full_like(first, stops.shape[1])).to(torch.int32)
        mel_lengths = lengths_steps * self.decoder.r
        frame_idx = torch.arange(mel_pre.shape[1], device=mel_pre.device)
        frame_mask = (frame_idx[None, :] < mel_lengths[:, None]).float()[..., None]
        mel_pre = mel_pre * frame_mask
        with telemetry.span("synth.postnet"):
            mel_post = mel_pre + self.postnet(mel_pre, self.compute_dtype)
        out = {
            "mel_pre": mel_pre,
            "mel_post": mel_post * frame_mask,
            "stop_logits": stops,
            "alignments": aligns,
            "mel_lengths": mel_lengths,
        }
        if self.linear_head is not None:
            with telemetry.span("synth.linear"):
                out["linear"] = self.linear_head(mel_post, self.compute_dtype) * frame_mask
        return out

    # -- streaming synthesis ---------------------------------------------------
    @torch.no_grad()
    def infer_stream_init(self, tokens, token_lengths, speaker_embedding,
                          active_rows=None) -> dict:
        """Streaming decode state: encoder memory and the zero decoder state;
        PAD rows (``active_rows`` False) start stopped, as in :meth:`infer`."""
        memory, mask = self.build_memory(tokens, token_lengths, speaker_embedding)
        carry, prev = self.decoder.segment(memory, mask, "init", 0, 0.0, None,
                                           self.compute_dtype)
        B = tokens.shape[0]
        stopped = (torch.zeros(B, dtype=torch.bool, device=tokens.device)
                   if active_rows is None else ~active_rows.to(torch.bool))
        return {"memory": memory, "mask": mask, "carry": carry, "prev": prev, "t0": 0,
                "stopped": stopped,
                "lengths": torch.zeros(B, dtype=torch.int32, device=tokens.device)}

    @torch.no_grad()
    def infer_stream_segment(self, state: dict, n_steps_seg: int, stop_threshold: float,
                             prenet_masks=None, max_decode_steps: int | None = None):
        """One segment of ``n_steps_seg`` AR steps from ``state`` -> (mel
        (B, n_steps_seg*r, mel) masked by decoded length as :meth:`infer`
        masks before the postnet, aligns, new state). The prenet masks come
        from ``prenet_masks(t)`` at the global step, so a streamed decode
        repeats the batched one. ``max_decode_steps`` caps the decoded
        lengths at the caller's budget (the streaming bucket rounds up to
        whole segments)."""
        mel_seg, _, aligns, upd = self.decoder.segment(
            state["memory"], state["mask"], state, n_steps_seg, stop_threshold,
            prenet_masks, self.compute_dtype)
        t0 = state["t0"]
        if max_decode_steps is not None:
            upd["lengths"] = torch.clamp(upd["lengths"], max=max_decode_steps)
            if t0 + n_steps_seg >= max_decode_steps:
                upd["stopped"] = torch.ones_like(upd["stopped"])
        step_idx = t0 + torch.arange(n_steps_seg, device=mel_seg.device)
        valid = (step_idx[None, :] < upd["lengths"][:, None]).float()
        mel_seg = mel_seg * valid.repeat_interleave(self.decoder.r, dim=1)[..., None]
        return mel_seg, aligns, dict(state, **upd, t0=t0 + n_steps_seg)

    @torch.no_grad()
    def stream_postnet_linear(self, mel_window: torch.Tensor,
                              boundary_mask: torch.Tensor | None = None):
        """Postnet and Conv head over a window of mel frames with explicit
        halos and the boundary mask -> (mel_post window, linear window or
        None); the window's centre frames equal :meth:`infer`'s."""
        if isinstance(self.linear_head, CBHGHead):
            raise NotImplementedError("the CBHG head's bidirectional GRU needs the whole "
                                      "sequence: it cannot run on a window")
        mel_post = mel_window + self.postnet(mel_window, self.compute_dtype,
                                             boundary_mask=boundary_mask)
        linear = None
        if self.linear_head is not None:
            linear = self.linear_head(mel_post, self.compute_dtype, boundary_mask=boundary_mask)
        return mel_post, linear
