"""The reconstructed reference architecture in PyTorch: the port's own copy
of ``multi_speaker_tts_tpu/convert/reference_torch.py``.

The reference's ``Modules.py`` is not in the repository; this module
rebuilds the architecture (encoder / prenet / location-sensitive attention
/ decoder / postnet / CBHG or Conv linear head / GE2E) with CODEJIN-style
module names, so that:

1. ``convert.mapping`` has a complete torch ``state_dict`` to map;
2. the tests and ``chip_smoke.py`` can hold whole-model forward parity
   (teacher-forced mel pre / post, stop logits, alignments, linear; GE2E
   embeddings) between a live torch model and its converted weights in the
   port's models, on the CPU and on the card.

The only changes from the JAX package's copy: the text vocabulary comes
from the port's ``text``, and the masks are built on the tokens' device,
so that the model also runs on a CUDA card.
"""

from __future__ import annotations


def _torch():
    import torch

    return torch


def build_reference_ge2e(hp):
    """Reference GE2E encoder: stacked LSTM -> projection -> L2 norm
    (SURVEY.md section 2 "GE2E speaker encoder"; Wan et al. 1710.10467)."""
    torch = _torch()
    nn = torch.nn
    spk = hp.Speaker_Embedding

    class GE2E(nn.Module):
        def __init__(self):
            super().__init__()
            self.lstm = nn.LSTM(
                hp.Sound.Mel_Dim,
                spk.GE2E.LSTM.Sizes,
                num_layers=spk.GE2E.LSTM.Stacks,
                batch_first=True,
            )
            self.projection = nn.Linear(spk.GE2E.LSTM.Sizes, spk.Embedding_Size)

        def forward(self, mels):  # (B, L, M) -> (B, E) unit norm
            outputs, _ = self.lstm(mels)
            emb = self.projection(outputs[:, -1])
            norm = emb.norm(dim=-1, keepdim=True).clamp(min=1e-6)
            return emb / norm

    return GE2E()


def build_reference_tacotron(hp):
    """Reference synthesizer, teacher-forced forward only (the conversion
    parity path). Per-frame Python decode loop exactly as the reference runs
    it (SURVEY.md section 3.2 "HOTTEST loop") - the antithesis of the JAX
    scan, which is the point: same math, different machine."""
    torch = _torch()
    nn = torch.nn
    F = torch.nn.functional

    mel_dim = hp.Sound.Mel_Dim
    r = hp.Decoder.get("N_Frames_Per_Step", 1)
    spk_size = (
        hp.Speaker_Embedding.Embedding_Size
        if hp.Speaker_Embedding.get("Type")
        else 0
    )
    enc_out = hp.Encoder.LSTM_Size  # BiLSTM total output size
    memory_size = enc_out + spk_size
    lstm_size = hp.Decoder.LSTM.Sizes
    lstm_stacks = hp.Decoder.LSTM.Stacks
    attn_size = hp.Decoder.Attention.Size
    prenet_sizes = list(hp.Decoder.Prenet.Sizes)
    prenet_dropout = hp.Decoder.Prenet.Dropout_Rate

    from multi_speaker_tts_tpu_torch.text import vocab_size

    class Encoder(nn.Module):
        def __init__(self):
            super().__init__()
            e = hp.Encoder
            self.embedding = nn.Embedding(vocab_size(hp), e.Embedding_Size)
            convs, norms = [], []
            ch_in = e.Embedding_Size
            for _ in range(e.Conv.Stacks):
                convs.append(
                    nn.Conv1d(
                        ch_in, e.Conv.Channels, e.Conv.Kernel_Size,
                        padding=(e.Conv.Kernel_Size - 1) // 2,
                    )
                )
                norms.append(nn.BatchNorm1d(e.Conv.Channels, momentum=0.1))
                ch_in = e.Conv.Channels
            self.convs = nn.ModuleList(convs)
            self.norms = nn.ModuleList(norms)
            self.lstm = nn.LSTM(
                ch_in, e.LSTM_Size // 2, batch_first=True, bidirectional=True
            )

        def forward(self, tokens):  # (B, S) -> (B, S, enc_out)
            x = self.embedding(tokens).transpose(1, 2)  # (B, C, S)
            for conv, norm in zip(self.convs, self.norms):
                x = F.relu(norm(conv(x)))
                x = F.dropout(x, hp.Encoder.Conv.Dropout_Rate, self.training)
            x, _ = self.lstm(x.transpose(1, 2))
            return x

    class Prenet(nn.Module):
        def __init__(self):
            super().__init__()
            sizes = [mel_dim] + prenet_sizes
            self.layers = nn.ModuleList(
                nn.Linear(i, o) for i, o in zip(sizes[:-1], sizes[1:])
            )

        def forward(self, x):
            for layer in self.layers:
                # Always-on dropout (Taco2 section 2.2); rate 0 in parity tests.
                x = F.dropout(F.relu(layer(x)), prenet_dropout, True)
            return x

    class Attention(nn.Module):
        def __init__(self):
            super().__init__()
            a = hp.Decoder.Attention
            self.query_layer = nn.Linear(lstm_size, attn_size, bias=False)
            self.memory_layer = nn.Linear(memory_size, attn_size, bias=False)
            self.location_conv = nn.Conv1d(
                2, a.Conv.Channels, a.Conv.Kernel_Size,
                padding=(a.Conv.Kernel_Size - 1) // 2, bias=False,
            )
            self.location_layer = nn.Linear(a.Conv.Channels, attn_size, bias=False)
            self.v = nn.Linear(attn_size, 1, bias=False)

        def forward(self, query, keys, memory, weights, cum_weights, mask):
            q = self.query_layer(query)  # (B, A)
            loc = self.location_conv(
                torch.stack([weights, cum_weights], dim=1)  # (B, 2, S)
            ).transpose(1, 2)  # (B, S, C)
            loc = self.location_layer(loc)
            energies = self.v(torch.tanh(q.unsqueeze(1) + keys + loc)).squeeze(-1)
            energies = energies.masked_fill(mask <= 0, -1e9)
            new_weights = torch.softmax(energies, dim=-1)
            context = torch.bmm(new_weights.unsqueeze(1), memory).squeeze(1)
            return context, new_weights, cum_weights + new_weights

    class Decoder(nn.Module):
        def __init__(self):
            super().__init__()
            self.prenet = Prenet()
            self.attention = Attention()
            cells = [nn.LSTMCell(prenet_sizes[-1] + memory_size, lstm_size)]
            for _ in range(1, lstm_stacks):
                cells.append(nn.LSTMCell(lstm_size + memory_size, lstm_size))
            self.cells = nn.ModuleList(cells)
            self.frame_proj = nn.Linear(lstm_size + memory_size, mel_dim * r)
            self.stop_proj = nn.Linear(lstm_size + memory_size, 1)

        def forward(self, memory, mask, teacher_mels):
            B, S, _ = memory.shape
            T = teacher_mels.shape[1]
            assert T % r == 0
            n_steps = T // r
            keys = self.attention.memory_layer(memory)

            hs = [memory.new_zeros(B, lstm_size) for _ in range(lstm_stacks)]
            cs = [memory.new_zeros(B, lstm_size) for _ in range(lstm_stacks)]
            weights = memory.new_zeros(B, S)
            weights[:, 0] = 1.0
            cum_weights = weights.clone()
            context = memory.new_zeros(B, memory.shape[-1])
            prev = memory.new_zeros(B, mel_dim)

            frames, stops, aligns = [], [], []
            for t in range(n_steps):
                pre = self.prenet(prev)
                hs[0], cs[0] = self.cells[0](
                    torch.cat([pre, context], dim=-1), (hs[0], cs[0])
                )
                context, weights, cum_weights = self.attention(
                    hs[0], keys, memory, weights, cum_weights, mask
                )
                x = torch.cat([hs[0], context], dim=-1)
                for i in range(1, lstm_stacks):
                    hs[i], cs[i] = self.cells[i](x, (hs[i], cs[i]))
                    x = torch.cat([hs[i], context], dim=-1)
                frame = self.frame_proj(x)  # (B, mel*r)
                frames.append(frame)
                stops.append(self.stop_proj(x).squeeze(-1))
                aligns.append(weights)
                # Teacher forcing: feed the LAST ground-truth frame of group t.
                prev = teacher_mels[:, t * r + r - 1]
            mel = torch.stack(frames, dim=1).reshape(B, n_steps * r, mel_dim)
            return mel, torch.stack(stops, dim=1), torch.stack(aligns, dim=1)

    class Postnet(nn.Module):
        def __init__(self):
            super().__init__()
            p = hp.Postnet.Conv
            convs, norms = [], []
            ch_in = mel_dim
            for i in range(p.Stacks):
                ch_out = mel_dim if i == p.Stacks - 1 else p.Channels
                convs.append(
                    nn.Conv1d(ch_in, ch_out, p.Kernel_Size,
                              padding=(p.Kernel_Size - 1) // 2)
                )
                norms.append(nn.BatchNorm1d(ch_out, momentum=0.1))
                ch_in = ch_out
            self.convs = nn.ModuleList(convs)
            self.norms = nn.ModuleList(norms)
            self.n = p.Stacks

        def forward(self, mel):  # (B, T, mel) -> residual
            x = mel.transpose(1, 2)
            for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
                x = norm(conv(x))
                if i < self.n - 1:
                    x = torch.tanh(x)
                x = F.dropout(x, hp.Postnet.Conv.Dropout_Rate, self.training)
            return x.transpose(1, 2)

    class Highway(nn.Module):
        def __init__(self, size):
            super().__init__()
            self.H = nn.Linear(size, size)
            self.T = nn.Linear(size, size)
            nn.init.constant_(self.T.bias, -1.0)

        def forward(self, x):
            t = torch.sigmoid(self.T(x))
            return F.relu(self.H(x)) * t + x * (1.0 - t)

    class CBHG(nn.Module):
        """Taco1 section 3.1 CBHG. Padding mirrors XLA SAME semantics so
        even-kernel bank convs and the w=2 max-pool match the JAX model:
        total pad k-1 split (left=(k-1)//2, right=k//2)."""

        def __init__(self, in_dim, cfg):
            super().__init__()
            K, C = cfg.Bank_K, cfg.Bank_Channels
            P = cfg.Projection_Channels
            self.bank = nn.ModuleList(
                nn.Conv1d(in_dim, C, k) for k in range(1, K + 1)
            )
            self.bank_norms = nn.ModuleList(
                nn.BatchNorm1d(C, momentum=0.1) for _ in range(K)
            )
            self.projs = nn.ModuleList(
                [nn.Conv1d(K * C, P, 3, padding=1),
                 nn.Conv1d(P, in_dim, 3, padding=1)]
            )
            self.proj_norms = nn.ModuleList(
                [nn.BatchNorm1d(P, momentum=0.1),
                 nn.BatchNorm1d(in_dim, momentum=0.1)]
            )
            H = cfg.Highway.Size
            self.pre_highway = (
                nn.Linear(in_dim, H) if in_dim != H else nn.Identity()
            )
            self.highways = nn.ModuleList(
                Highway(H) for _ in range(cfg.Highway.Layers)
            )
            self.gru = nn.GRU(
                H, cfg.GRU_Size // 2, batch_first=True, bidirectional=True
            )

        def forward(self, x):  # (B, T, D) -> (B, T, gru_size)
            xc = x.transpose(1, 2)  # (B, D, T)
            outs = []
            for k, (conv, norm) in enumerate(
                zip(self.bank, self.bank_norms), start=1
            ):
                padded = F.pad(xc, ((k - 1) // 2, k // 2))
                outs.append(F.relu(norm(conv(padded))))
            y = torch.cat(outs, dim=1)  # (B, K*C, T)
            y = F.max_pool1d(
                F.pad(y, (0, 1), value=float("-inf")), 2, stride=1
            )
            y = F.relu(self.proj_norms[0](self.projs[0](y)))
            y = self.proj_norms[1](self.projs[1](y))
            y = y.transpose(1, 2) + x  # residual
            y = self.pre_highway(y)
            for hw in self.highways:
                y = hw(y)
            out, _ = self.gru(y)
            return out

    class CBHGHead(nn.Module):
        def __init__(self):
            super().__init__()
            cfg = hp.Linear_Head.CBHG
            self.cbhg = CBHG(mel_dim, cfg)
            self.projection = nn.Linear(cfg.GRU_Size, hp.Sound.Spectrogram_Dim)

        def forward(self, mel):
            return self.projection(self.cbhg(mel))

    class LinearHead(nn.Module):
        def __init__(self):
            super().__init__()
            lh = hp.Linear_Head.Conv
            convs, norms = [], []
            ch_in = mel_dim
            for _ in range(lh.Stacks):
                convs.append(
                    nn.Conv1d(ch_in, lh.Channels, lh.Kernel_Size,
                              padding=(lh.Kernel_Size - 1) // 2)
                )
                norms.append(nn.BatchNorm1d(lh.Channels, momentum=0.1))
                ch_in = lh.Channels
            self.convs = nn.ModuleList(convs)
            self.norms = nn.ModuleList(norms)
            self.projection = nn.Linear(ch_in, hp.Sound.Spectrogram_Dim)

        def forward(self, mel):
            x = mel.transpose(1, 2)
            for conv, norm in zip(self.convs, self.norms):
                x = F.relu(norm(conv(x)))
                x = F.dropout(x, hp.Linear_Head.Conv.Dropout_Rate, self.training)
            return self.projection(x.transpose(1, 2))

    class Tacotron(nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = Encoder()
            self.decoder = Decoder()
            self.postnet = Postnet()
            lh = hp.get("Linear_Head")
            if lh is not None and lh.Use:
                self.linear_head = (
                    CBHGHead() if lh.get("Type", "Conv") == "CBHG"
                    else LinearHead()
                )

        def forward(self, tokens, token_lengths, teacher_mels, speaker_embedding=None):
            memory = self.encoder(tokens)
            if spk_size:
                spk = speaker_embedding.unsqueeze(1).expand(
                    -1, memory.shape[1], -1
                )
                memory = torch.cat([memory, spk], dim=-1)
            mask = (
                torch.arange(tokens.shape[1], device=tokens.device)[None, :]
                < token_lengths[:, None]
            ).to(memory.dtype)
            mel_pre, stops, aligns = self.decoder(memory, mask, teacher_mels)
            mel_post = mel_pre + self.postnet(mel_pre)
            out = {
                "mel_pre": mel_pre,
                "mel_post": mel_post,
                "stop_logits": stops,
                "alignments": aligns,
            }
            if hasattr(self, "linear_head"):
                out["linear"] = self.linear_head(mel_post)
            return out

    return Tacotron()


def save_reference_checkpoint(path: str, tacotron=None, ge2e=None,
                              steps: int = 0) -> None:
    """Write a reference-style ``torch.save({'Model': ..., 'Steps': ...})``
    file (SURVEY.md section 5 "Checkpoint / resume"). When both models are
    given, GE2E keys are namespaced under ``ge2e.`` alongside the
    synthesizer's (the SV2TTS single-file layout)."""
    torch = _torch()
    state = {}
    if tacotron is not None:
        state.update(tacotron.state_dict())
    if ge2e is not None:
        state.update({f"ge2e.{k}": v for k, v in ge2e.state_dict().items()})
    torch.save({"Model": state, "Steps": steps}, path)
