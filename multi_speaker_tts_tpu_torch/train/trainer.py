"""The teacher-forced train step (port of ``make_train_step`` /
``make_eval_step`` in ``multi_speaker_tts_tpu.train.trainer``).

``Trainer.from_compact(path)`` -> ``train_step(batch)`` with a batch in the
``collate_tts`` layout, on a CUDA device by default. One step:

- GE2E conditioning on the reference crops (``Speaker_Embedding.GE2E.Freeze``:
  under ``no_grad``, the JAX ``stop_gradient``; otherwise through the LSTM
  stack's autograd Function, whose backward is ``csrc/lstm_bwd.cu``);
- the teacher-forced Tacotron forward in train mode (BatchNorm batch
  statistics, conv dropout and the prenet's keep masks from the trainer's
  generator), the BiLSTM and BiGRU through their autograd Functions
  (backwards ``csrc/bilstm_bwd.cu``, ``csrc/bigru_bwd.cu``);
- the losses, gradients by ``torch.autograd``;
- the optimizer chain of :mod:`.optim`, applied in place (which bumps each
  parameter's version, so the kernels' packed weight layouts are rebuilt
  on the next step). With ``Freeze`` the GE2E updates are dropped, as the
  JAX step zeroes them.

The non-finite guard: when the total loss or the gradient norm is not
finite, nothing changes -- no update reaches the parameters or the
optimizer state, and the BatchNorm running statistics that the forward
already moved are restored from a snapshot taken before it. The step count
still advances. Metrics come back as floats (one host read a step).

A fresh random init, the data loader, checkpoint saving, logging and
multi-GPU training are not ported yet.
"""

from __future__ import annotations

import torch

from multi_speaker_tts_tpu_torch.checkpoints import load_compact
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
from multi_speaker_tts_tpu_torch.inference import resolve_device
from multi_speaker_tts_tpu_torch.models.ge2e import GE2E
from multi_speaker_tts_tpu_torch.models.losses import tacotron_losses
from multi_speaker_tts_tpu_torch.models.tacotron import Tacotron
from multi_speaker_tts_tpu_torch.ops.numerics import compute_dtype_of
from multi_speaker_tts_tpu_torch.train.optim import global_norm, make_optimizer
from multi_speaker_tts_tpu_torch.weights import load_into, module_state, params_from_jax

_BATCH_KEYS = ("tokens", "token_lengths", "mels", "mel_lengths", "ref_mels", "spects")


def build_models(hp, compute_dtype) -> tuple[Tacotron, GE2E | None]:
    """(Tacotron, the GE2E encoder or None for an unconditioned model)."""
    spk_type = hp.Speaker_Embedding.get("Type")
    if spk_type not in ("GE2E", None):
        raise NotImplementedError("the torch port has the GE2E speaker encoder only")
    ge2e = GE2E.from_hp(hp, compute_dtype) if spk_type == "GE2E" else None
    return Tacotron(hp, compute_dtype), ge2e


def resolve_guided_attention(hp) -> tuple[float | None, float]:
    """(sigma, weight) as the objective uses them: (None, 0.0) when guided
    attention is off, so eval totals match train totals."""
    ga = hp.Train.get("Guided_Attention")
    if ga is not None and ga.Use:
        return ga.Sigma, ga.Weight
    return None, 0.0


class Trainer:
    """Teacher-forced training of the GE2E-conditioned Tacotron on one
    device, from a compact checkpoint's params and batch_stats with a fresh
    optimizer state."""

    def __init__(self, hp, params, batch_stats, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.hp = hp
        self.compute_dtype = compute_dtype_of(hp)
        self.tacotron, self.ge2e = build_models(hp, self.compute_dtype)
        state = params_from_jax(params, batch_stats, hp)
        load_into(self.tacotron, state, "tacotron.")
        self.tacotron.to(self.device)
        if self.ge2e is not None:
            load_into(self.ge2e, state, "ge2e.")
            self.ge2e.to(self.device)
        self.freeze_ge2e = bool(self.ge2e is not None
                                and hp.Speaker_Embedding.GE2E.get("Freeze", False))
        self.r = int(hp.Decoder.get("N_Frames_Per_Step", 1))
        self.ga_sigma, self.ga_weight = resolve_guided_attention(hp)
        named = [] if self.ge2e is None else [
            (f"ge2e.{n}", t) for n, t in self.ge2e.named_parameters()]
        named += [(f"tacotron.{n}", t) for n, t in self.tacotron.named_parameters()]
        self.param_names = [n for n, _ in named]  # state keys, as weights.py names them
        self.params = [t for _, t in named]
        self.frozen = [self.freeze_ge2e and n.startswith("ge2e.") for n in self.param_names]
        self.optimizer = make_optimizer(hp)
        self.opt_state = self.optimizer.init(self.params)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.step = 0

    @classmethod
    def from_compact(cls, path, hp=None, device=None, seed: int = 0) -> "Trainer":
        """Load an ``export_compact`` checkpoint; hp from its ``meta["hp"]``
        unless given."""
        params, batch_stats, meta = load_compact(path)
        if hp is None:
            if "hp" not in meta:
                raise ValueError(f"{path} carries no hp; pass one explicitly")
            hp = Recursive_Parse(meta["hp"])
        return cls(hp, params, batch_stats, device=device, seed=seed)

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(batch[k]).to(self.device) for k in _BATCH_KEYS if k in batch}

    def _speaker_embedding(self, batch: dict):
        if self.ge2e is None:
            return None
        if self.freeze_ge2e:
            with torch.no_grad():
                return self.ge2e(batch["ref_mels"].float())
        return self.ge2e(batch["ref_mels"].float())

    def _losses(self, batch: dict, outputs: dict) -> dict:
        return tacotron_losses(
            outputs, batch["mels"], batch["mel_lengths"], batch["token_lengths"],
            spects=batch.get("spects"), n_frames_per_step=self.r,
            guided_attention_sigma=self.ga_sigma, guided_attention_weight=self.ga_weight)

    def bn_stats(self) -> list[torch.Tensor]:
        """The BatchNorm running statistics, in module order."""
        return [b for name, b in self.tacotron.named_buffers()
                if name.endswith(("bn_mean", "bn_var"))]

    def _forward_backward(self, batch: dict):
        """Train-mode forward on a device batch -> (losses, gradients in
        ``self.params`` order; zeros where none flows)."""
        outputs = self.tacotron(batch["tokens"], batch["token_lengths"], batch["mels"],
                                self._speaker_embedding(batch), train=True,
                                generator=self.generator)
        losses = self._losses(batch, outputs)
        grads = torch.autograd.grad(losses["total"], self.params, allow_unused=True)
        return losses, [torch.zeros_like(p) if g is None else g
                        for p, g in zip(self.params, grads)]

    def gradients(self, batch: dict) -> tuple[dict, dict]:
        """The train step's forward and backward without the update ->
        (losses as floats, ``{state key: gradient}`` as numpy). The forward
        is in train mode, so it moves the BatchNorm running statistics."""
        losses, grads = self._forward_backward(self._to_device(batch))
        return ({k: float(v.detach()) for k, v in losses.items()},
                {n: g.detach().cpu().numpy() for n, g in zip(self.param_names, grads)})

    def train_step(self, batch: dict) -> dict:
        """One teacher-forced step -> metrics: ``total``, each loss,
        ``grad_norm`` (of the raw gradients) and ``skipped_nonfinite``."""
        batch = self._to_device(batch)
        snapshot = [b.clone() for b in self.bn_stats()]
        losses, grads = self._forward_backward(batch)
        grad_norm = global_norm(grads)
        finite = bool(torch.isfinite(losses["total"]) & torch.isfinite(grad_norm))
        if finite:
            updates, self.opt_state = self.optimizer.update(grads, self.opt_state, self.params)
            with torch.no_grad():
                for p, u, frozen in zip(self.params, updates, self.frozen):
                    if not frozen:
                        p.add_(u)
        else:
            with torch.no_grad():
                for b, saved in zip(self.bn_stats(), snapshot):
                    b.copy_(saved)
        self.step += 1
        metrics = {k: float(v.detach()) for k, v in losses.items()}
        metrics["grad_norm"] = float(grad_norm)
        metrics["skipped_nonfinite"] = 0.0 if finite else 1.0
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: dict) -> tuple[dict, dict]:
        """Teacher-forced evaluation -> (losses as floats, outputs): running
        BatchNorm statistics, no conv dropout, the prenet still stochastic."""
        batch = self._to_device(batch)
        outputs = self.tacotron(batch["tokens"], batch["token_lengths"], batch["mels"],
                                self._speaker_embedding(batch), train=False,
                                generator=self.generator)
        return {k: float(v) for k, v in self._losses(batch, outputs).items()}, outputs

    def state(self) -> dict:
        """The flat ``ge2e.*`` / ``tacotron.*`` state (numpy), as
        ``weights.params_to_jax`` reads it."""
        return module_state(ge2e=self.ge2e, tacotron=self.tacotron)
