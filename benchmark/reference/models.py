"""Plain reference models, written from their papers and read from the
checkpoint's own tree (flax layout: Dense kernels (in, out); Conv kernels
(K, in, out) with SAME padding; LSTM w_ih (D, 4H), w_hh (H, 4H), one bias,
gates (i, f, g, o); GRU w_ih (D, 3H), w_hh (H, 3H), two biases, gates (r, z,
n) with the reset gate applied to W_hn h + b_hn; BatchNorm as scale, bias
and running statistics, epsilon 1e-5). Recurrences are loops of one step,
every product through :class:`.lowp.Arith`, so that the same code is the
float32 reference and its fp8 control.

- Tacotron 2 (arXiv 1712.05884) with an SV2TTS speaker embedding
  concatenated onto the encoder memory (arXiv 1806.04558), r frames a
  decoder step, always-on prenet dropout (its keep masks given), a
  location-sensitive attention (initial weights on the first position, the
  cumulative weights beside the last ones), and a Tacotron 1 CBHG head
  (arXiv 1703.10135) to the linear spectrogram;
- the GE2E speaker encoder (arXiv 1710.10467): stacked LSTMs, the last
  frame's output projected and L2-normalized, and its softmax loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.lowp import FULL, Arith

BN_EPS = 1e-5


def _t(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return _t(tree, device)


def dense(p, x, ar: Arith = FULL):
    y = ar.mm(x, p["kernel"])
    return y + p["bias"] if "bias" in p else y


def conv_bn(p, stats, x, act: str, ar: Arith = FULL, left=None, right=None):
    k = p["Conv_0"]["kernel"].shape[0]
    left = (k - 1) // 2 if left is None else left
    right = k // 2 if right is None else right
    y = ar.conv1d(x, p["Conv_0"]["kernel"], p["Conv_0"].get("bias"), left, right)
    bn, st = p["BatchNorm_0"], stats["BatchNorm_0"]
    y = (y - st["mean"]) / torch.sqrt(st["var"] + BN_EPS) * bn["scale"] + bn["bias"]
    if act == "relu":
        return torch.relu(y)
    if act == "tanh":
        return torch.tanh(y)
    return y


def lstm_step(p, xw, h, c, ar: Arith = FULL):
    """One step given ``xw`` = x W_ih + b."""
    g = xw + ar.mm(h, p["w_hh"])
    i, f, gg, o = g.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_seq(p, x, ar: Arith = FULL, reverse: bool = False):
    """(B, T, D) -> (B, T, H), zero initial state."""
    B, T, _ = x.shape
    H = p["w_hh"].shape[0]
    xw = ar.mm(x, p["w_ih"]) + p["b"]
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    out = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h, c = lstm_step(p, xw[:, t], h, c, ar)
        out[t] = h
    return torch.stack(out, dim=1)


def gru_seq(p, x, ar: Arith = FULL, reverse: bool = False):
    B, T, _ = x.shape
    H = p["w_hh"].shape[0]
    xw = ar.mm(x, p["w_ih"]) + p["b_ih"]
    h = x.new_zeros(B, H)
    out = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gh = ar.mm(h, p["w_hh"]) + p["b_hh"]
        xr, xz, xn = xw[:, t].chunk(3, dim=-1)
        hr, hz, hn = gh.chunk(3, dim=-1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        out[t] = h
    return torch.stack(out, dim=1)


# -- Tacotron ------------------------------------------------------------------
def encode(P, S, tokens, ar: Arith = FULL):
    """(B, S) ids -> (B, S, 2 x 256): embedding, 3 conv / BN / ReLU, BiLSTM
    over the whole padded row (as the model runs it)."""
    e, es = P["encoder"], S["encoder"]
    x = e["embedding"]["embedding"][tokens]
    i = 0
    while f"conv_{i}" in e:
        x = conv_bn(e[f"conv_{i}"], es[f"conv_{i}"], x, "relu", ar)
        i += 1
    return torch.cat([lstm_seq(e["bilstm"]["forward"], x, ar),
                      lstm_seq(e["bilstm"]["backward"], x, ar, reverse=True)], dim=-1)


def memory(P, S, tokens, lengths, spk, ar: Arith = FULL):
    enc = encode(P, S, tokens, ar)
    mem = torch.cat([enc, spk[:, None, :].expand(-1, enc.shape[1], -1)], dim=-1)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    return mem, (pos[None, :] < lengths[:, None]).float()


def decode_teacher_forced(P, mem, mask, inputs, keep, keep_prob: float, ar: Arith = FULL,
                          attention=None):
    """The decoder run over given inputs: step t reads ``inputs[:, t]``
    (the last frame of group t - 1, zeros first) and ``keep[l][:, t]``, the
    prenet's keep mask of layer l; given ``attention`` (B, n, S), the attention
    at step t also reads its previous and cumulative weights from them
    (those of step t - 1, and the first position before step 0) instead of
    its own. -> frames (B, n, mel r), stop logits (B, n), alignments (B, n,
    S)."""
    d = P["decoder"]
    cell, att = d["cell"], d["cell"]["attention"]
    B, Sm, _ = mem.shape
    keys = ar.mm(mem, d["memory_layer"]["kernel"])
    L = 0
    while f"lstm_{L}" in cell:
        L += 1
    H = cell["lstm_0"]["w_hh"].shape[0]
    hs = [mem.new_zeros(B, H) for _ in range(L)]
    cs = [mem.new_zeros(B, H) for _ in range(L)]
    w = mem.new_zeros(B, Sm)
    w[:, 0] = 1.0
    cum = w.clone()
    ctx = mem.new_zeros(B, mem.shape[-1])
    if attention is not None:  # each step's previous and cumulative weights, as given
        prev_w = torch.cat([w[:, None], attention[:, :-1]], dim=1)
        prev_cum = torch.cumsum(prev_w, dim=1)
    K = att["location_conv"]["kernel"].shape[0]
    frames, stops, aligns = [], [], []
    n_pre = 0
    while f"dense_{n_pre}" in d["prenet"]:
        n_pre += 1
    for t in range(inputs.shape[1]):
        x = inputs[:, t]
        for li in range(n_pre):
            x = torch.relu(dense(d["prenet"][f"dense_{li}"], x, ar))
            x = torch.where(keep[li][:, t], x / keep_prob, torch.zeros_like(x))
        inp = torch.cat([x, ctx], dim=-1)
        for li in range(L):
            p = cell[f"lstm_{li}"]
            hs[li], cs[li] = lstm_step(p, ar.mm(inp, p["w_ih"]) + p["b"], hs[li], cs[li], ar)
            if li == 0:
                if attention is not None:
                    w, cum = prev_w[:, t], prev_cum[:, t]
                q = ar.mm(hs[0], att["query_layer"]["kernel"])
                loc = ar.conv1d(torch.stack([w, cum], dim=-1), att["location_conv"]["kernel"],
                                None, (K - 1) // 2, K // 2)
                loc = ar.mm(loc, att["location_layer"]["kernel"])
                e = ar.mm(torch.tanh(q[:, None, :] + keys + loc), att["v"]["kernel"])[..., 0]
                e = e.masked_fill(mask <= 0, -1e9)
                w = torch.softmax(e, dim=-1)
                cum = cum + w
                ctx = ar.mm(w[:, None, :], mem)[:, 0]
            inp = torch.cat([hs[li], ctx], dim=-1)
        frames.append(dense(d["frame_proj"], inp, ar))
        stops.append(dense(d["stop_proj"], inp, ar)[:, 0])
        aligns.append(w)
    return torch.stack(frames, 1), torch.stack(stops, 1), torch.stack(aligns, 1)


def postnet(P, S, mel, ar: Arith = FULL):
    p, s = P["postnet"], S["postnet"]
    n = 0
    while f"conv_{n}" in p:
        n += 1
    x = mel
    for i in range(n):
        x = conv_bn(p[f"conv_{i}"], s[f"conv_{i}"], x, "tanh" if i < n - 1 else "none", ar)
    return x


def cbhg_linear(P, S, mel, ar: Arith = FULL):
    """(B, T, mel) -> (B, T, n_fft / 2 + 1)."""
    c, cs = P["linear_head"]["cbhg"], S["linear_head"]["cbhg"]
    banks, k = [], 0
    while f"bank_{k}" in c:
        banks.append(conv_bn(c[f"bank_{k}"], cs[f"bank_{k}"], mel, "relu", ar))
        k += 1
    y = torch.cat(banks, dim=-1)
    y = torch.maximum(y, F.pad(y[:, 1:], (0, 0, 0, 1), value=float("-inf")))
    y = conv_bn(c["proj_0"], cs["proj_0"], y, "relu", ar)
    y = conv_bn(c["proj_1"], cs["proj_1"], y, "none", ar) + mel
    if "pre_highway" in c:
        y = dense(c["pre_highway"], y, ar)
    i = 0
    while f"highway_{i}" in c:
        hw = c[f"highway_{i}"]
        gate = torch.sigmoid(dense(hw["T"], y, ar))
        y = torch.relu(dense(hw["H"], y, ar)) * gate + y * (1.0 - gate)
        i += 1
    y = torch.cat([gru_seq(c["gru"]["forward"], y, ar),
                   gru_seq(c["gru"]["backward"], y, ar, reverse=True)], dim=-1)
    return dense(P["linear_head"]["projection"], y, ar)


# -- GE2E ------------------------------------------------------------------------
def ge2e_embed(G, windows, ar: Arith = FULL):
    """(N, L, mel) -> (N, E) unit-norm embeddings."""
    x = windows
    i = 0
    while f"lstm_{i}" in G:
        x = lstm_seq(G[f"lstm_{i}"], x, ar)
        i += 1
    e = dense(G["projection"], x[:, -1], ar)
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-6)


def window_starts(T: int, win: int, shift: int) -> list[int]:
    T = max(T, win)
    W = max(1, 1 + max(0, T - win) // shift)
    return [min(w * shift, T - win) for w in range(W)]


def utterance_embedding(G, mel, true_frames, win: int, shift: int, ar: Arith = FULL):
    """(B, T, mel) padded utterances -> (B, E): the mean of the unit
    embeddings of the windows inside each row's real frames (the first
    window where none fits), renormalized."""
    B, T, M = mel.shape
    if T < win:
        mel = F.pad(mel, (0, 0, 0, win - T))
    starts = window_starts(T, win, shift)
    wins = torch.stack([mel[:, s:s + win] for s in starts], dim=1)
    embs = ge2e_embed(G, wins.reshape(-1, win, M), ar).reshape(B, len(starts), -1)
    st = torch.tensor(starts, device=mel.device)
    fits = st[None, :] + win <= true_frames[:, None]
    first = torch.arange(len(starts), device=mel.device)[None, :] == 0
    keep = torch.where(fits.any(dim=1, keepdim=True), fits, first).float()[..., None]
    mean = (embs * keep).sum(1) / keep.sum(1).clamp(min=1.0)
    return mean / torch.clamp(torch.linalg.vector_norm(mean, dim=-1, keepdim=True), min=1e-6)


def ge2e_loss(emb, w, b):
    """Softmax GE2E loss of (N, M, E) unit embeddings: the leave-one-out
    centroid for the own speaker, w clamped to at least 1e-6."""
    N, M, _ = emb.shape

    def unit(v):
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-6)

    cent = unit(emb.mean(1))
    loo = unit((emb.sum(1, keepdim=True) - emb) / (M - 1))
    cos = torch.einsum("jme,ke->jmk", emb, cent)
    own = torch.eye(N, device=emb.device, dtype=emb.dtype)[:, None, :]
    cos = cos * (1.0 - own) + (emb * loo).sum(-1)[..., None] * own
    S = torch.clamp(w, min=1e-6) * cos + b
    idx = torch.arange(N, device=emb.device)
    return (-S[idx, :, idx] + torch.logsumexp(S, dim=2)).mean()
