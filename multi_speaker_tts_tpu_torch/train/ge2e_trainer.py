"""Speaker-encoder training with the GE2E loss (port of
``multi_speaker_tts_tpu.train.ge2e_trainer``).

Batches of N speakers x M utterances of fixed-length mel crops
(:class:`..data.datasets.GE2EBatchSampler`) -> embeddings (the GE2E LSTM
stack through its autograd Function: kernel ``csrc/lstm.cu`` in residual
mode forward, ``csrc/lstm_bwd.cu`` backward, on the card) -> the
leave-one-out similarity matrix -> the softmax GE2E loss. The similarity's
scale and bias (w, b) learn at ``Scale_Gradient`` (0.01) times the
encoder's rate, w is clamped positive, and gradients are clipped to a
global norm of 3.0: :class:`GE2EOptimizer` computes what the JAX package's
optax chain computes.

Data parallelism: each of W processes embeds its contiguous share of the
N M rows; the embeddings are gathered in rank order with autograd
(:func:`..parallel.multihost.all_gather_rows`), so every process computes
the loss of the global N x M batch once, and scales it by 1 / W: the
gather's backward sums the processes' cotangents, so the shares' gradients,
summed over the processes, are the global loss's.

A step carries profiler spans (:mod:`..telemetry`): ``train.forward`` (the
embeddings and the loss), ``train.backward`` (the gradients) and
``train.update`` (the optimizer and the clamp of w).
"""

from __future__ import annotations

import torch

from multi_speaker_tts_tpu_torch import telemetry
from multi_speaker_tts_tpu_torch.data.datasets import GE2EBatchSampler, PatternDataset
from multi_speaker_tts_tpu_torch.inference import resolve_device
from multi_speaker_tts_tpu_torch.models.ge2e import GE2E, ge2e_loss
from multi_speaker_tts_tpu_torch.ops.numerics import compute_dtype_of
from multi_speaker_tts_tpu_torch.parallel import multihost
from multi_speaker_tts_tpu_torch.train.checkpoints import CheckpointManager
from multi_speaker_tts_tpu_torch.train.logger import Logger, NullLogger
from multi_speaker_tts_tpu_torch.train.optim import global_norm
from multi_speaker_tts_tpu_torch.weights import random_init

CLIP_NORM = 3.0  # GE2E section 3
MOMENTUM = 0.9


class GE2EOptimizer:
    """``make_ge2e_optimizer``'s chain over named parameters: clip by a
    global norm of 3, scale the w / b gradients by ``scale``, then SGD with
    momentum 0.9 (the trace g + 0.9 trace, the update -lr trace)."""

    def __init__(self, lr: float, scale: float = 0.01):
        self.lr, self.scale = lr, scale

    def init(self, params: dict) -> dict:
        return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}

    @torch.no_grad()
    def update(self, grads: dict, trace: dict) -> tuple[dict, dict]:
        """(updates to add to the parameters, the next trace)."""
        g_norm = global_norm(list(grads.values()))
        grads = {k: g.float() for k, g in grads.items()}
        if not bool(g_norm < CLIP_NORM):
            grads = {k: g / g_norm * CLIP_NORM for k, g in grads.items()}
        for k in ("w", "b"):
            grads[k] = grads[k] * self.scale
        trace = {k: grads[k] + MOMENTUM * trace[k] for k in grads}
        return {k: -self.lr * t for k, t in trace.items()}, trace


def make_ge2e_optimizer(hp) -> GE2EOptimizer:
    g = hp.GE2E_Train
    return GE2EOptimizer(g.Learning_Rate, g.get("Scale_Gradient", 0.01))


class GE2ETrainer:
    """Training loop of the speaker encoder on one device a process (CUDA
    unless ``device`` says otherwise). ``params`` holds ``encoder.<state
    key>``, ``w`` and ``b``; checkpoints hold ``{"step", "params":
    {"encoder": {...}, "w", "b"}, "opt_state"}``, written by process 0 of a
    data-parallel run only. ``n_devices`` must equal the process group's
    size (1 without one): the port trains data-parallel with one process a
    device."""

    def __init__(self, hp, checkpoint_dir: str | None = None, log_dir: str | None = None,
                 device=None, seed: int = 0, n_devices: int | None = None):
        self.hp = hp
        self.device = resolve_device(device)
        self.N, self.M = hp.GE2E_Train.Batch_Speakers, hp.GE2E_Train.Batch_Utterances
        self.process_count = multihost.checked_process_count(n_devices, self.N * self.M,
                                                             "GE2E batch rows N*M")
        self.is_main = multihost.process_index() == 0
        self.model = GE2E.from_hp(hp, compute_dtype_of(hp))
        random_init(hp, torch.Generator().manual_seed(seed), ge2e=self.model)
        self.model.to(self.device)
        loss = hp.Speaker_Embedding.GE2E.Loss
        scalar = lambda v: torch.tensor(float(v), device=self.device)  # noqa: E731
        self.params = {f"encoder.{k}": p for k, p in self.model.named_parameters()}
        self.params["w"] = scalar(loss.Initial_Weight).requires_grad_()
        self.params["b"] = scalar(loss.Initial_Bias).requires_grad_()
        self.optimizer = make_ge2e_optimizer(hp)
        self.opt_state = self.optimizer.init(self.params)
        self.step = 0
        self.checkpoints = (CheckpointManager(checkpoint_dir or hp.Checkpoint_Path)
                            if self.is_main else None)
        self.logger = (Logger if self.is_main else NullLogger)(log_dir or hp.Log_Path)

    def state(self) -> dict:
        """The checkpoint's state: tensors on the CPU."""
        cpu = lambda t: t.detach().cpu().clone()  # noqa: E731
        enc = {k[len("encoder."):]: cpu(p) for k, p in self.params.items()
               if k.startswith("encoder.")}
        return {"step": self.step,
                "params": {"encoder": enc, "w": cpu(self.params["w"]), "b": cpu(self.params["b"])},
                "opt_state": {k: cpu(t) for k, t in self.opt_state.items()}}

    def sync_state(self) -> None:
        """Give every process of a data-parallel run process 0's params,
        optimizer trace and step (a no-op alone), after a barrier."""
        if self.process_count <= 1:
            return
        multihost.barrier("ge2e_state")
        step = torch.tensor([self.step], dtype=torch.int64)
        multihost.broadcast_state([*self.params.values(), *self.opt_state.values(), step])
        self.step = int(step[0])

    @torch.no_grad()
    def load_state(self, state: dict) -> None:
        for k, p in self.params.items():
            src = state["params"]["encoder"][k[len("encoder."):]] if k.startswith("encoder.") \
                else state["params"][k]
            p.copy_(src)
        self.opt_state = {k: t.to(self.device) for k, t in state["opt_state"].items()}
        self.step = int(state["step"])

    def gradients(self, mels) -> tuple[torch.Tensor, dict]:
        """(the global batch's loss, its gradients by parameter name) from
        this process's rows of the (N M, L, mel) crops grouped by speaker."""
        with telemetry.span("train.forward"):
            mels = torch.as_tensor(mels).to(self.device).float()
            emb = multihost.all_gather_rows(self.model(mels)).reshape(self.N, self.M, -1)
            loss = ge2e_loss(emb, self.params["w"], self.params["b"])
        names = list(self.params)
        with telemetry.span("train.backward"):
            grads = multihost.all_reduce_sum(list(torch.autograd.grad(
                loss / self.process_count, [self.params[k] for k in names])))
        return loss.detach(), dict(zip(names, grads))

    def train_step(self, mels) -> dict:
        """One step on this process's rows of the (N M, L, mel) crops
        grouped by speaker -> loss, w, b."""
        loss, grads = self.gradients(mels)
        names = list(self.params)
        with telemetry.span("train.update"), torch.no_grad():
            updates, self.opt_state = self.optimizer.update(grads, self.opt_state)
            for k in names:
                self.params[k].add_(updates[k])
            self.params["w"].clamp_(min=1e-6)
        self.step += 1
        return {"loss": float(loss.detach()), "w": float(self.params["w"].detach()),
                "b": float(self.params["b"].detach())}

    def train(self, pattern_dir: str, max_steps: int, log_interval: int = 50,
              save_interval: int = 500) -> dict:
        """Resume from the latest checkpoint if there is one, then step to
        ``max_steps``, saving every ``save_interval`` steps and at the end.
        Returns the last step's metrics."""
        hp = self.hp
        sampler = GE2EBatchSampler(PatternDataset(pattern_dir), n_speakers=self.N,
                                   m_utterances=self.M,
                                   frame_length=hp.GE2E_Train.Frame_Length)
        if self.is_main:
            restored, step = self.checkpoints.restore()
            if restored is not None and step > self.step:
                self.load_state(restored)
                print(f"resumed GE2E training from step {step}")
        self.sync_state()
        rows = multihost.local_rows(self.N * self.M)
        metrics = {}
        while self.step < max_steps:
            metrics = self.train_step(sampler.sample()["mels"][rows])
            if self.step % log_interval == 0:
                self.logger.add_scalar_dict("GE2E", metrics, self.step)
            if self.is_main and (self.step % save_interval == 0 or self.step >= max_steps):
                self.checkpoints.save(self.step, self.state())
        self.logger.flush()
        return metrics
