"""The Tacotron trainer (port of ``multi_speaker_tts_tpu.train.trainer``).

``Trainer(hp, checkpoint_dir, log_dir)`` on a CUDA device by default;
:meth:`Trainer.initialize` draws a fresh init (the JAX initializers'
families, :func:`..weights.random_init`), then resumes from the checkpoint
directory's latest step or, for a GE2E model, grafts a pretrained encoder
(``Speaker_Embedding.GE2E.Pretrained_Checkpoint``, the SV2TTS recipe);
``from_params`` / ``from_compact`` start from given weights. :meth:`train`
runs the loop over a pattern directory: bucketed batches (in process, or
``Train.Num_Workers`` loader processes), a step a batch, logs, checkpoints,
evaluation and an inference sample at the configured intervals, and a
``torch.profiler`` trace over :attr:`profile_steps`.

One step (:meth:`train_step`):

- speaker conditioning: GE2E on the reference crops (``Freeze``: under
  ``no_grad``, the JAX ``stop_gradient``; otherwise through the LSTM stack's
  autograd Function, whose backward is ``csrc/lstm_bwd.cu``), or the LUT
  rows of the batch's ``speaker_ids``;
- the teacher-forced Tacotron forward in train mode (BatchNorm batch
  statistics, conv dropout and the prenet's keep masks from the trainer's
  generator), the BiLSTM and BiGRU through their autograd Functions
  (backwards ``csrc/bilstm_bwd.cu``, ``csrc/bigru_bwd.cu``) and the decoder
  scan through its hand-written backward (:func:`..ops.decoder_scan.decoder_tf_scan`);
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

Data parallelism (:mod:`..parallel.multihost`): one process a device, all
started with the same hparams and seed after
``multihost.initialize_distributed``. Each process steps on its
contiguous share of every global batch (``Train.Batch_Size`` rows over W
processes); the BatchNorm statistics, the dropout masks and the loss
denominators are the global batch's, the gradients are summed over the
processes before the norm, the guard and the optimizer, so every process
makes the single-device step's update on the global batch. Only process 0
reads and writes checkpoints and logs; it broadcasts the state it starts
from (fresh, resumed or grafted) to the others.
"""

from __future__ import annotations

import pathlib
import time

import numpy as np
import torch

from multi_speaker_tts_tpu_torch.audio import dsp
from multi_speaker_tts_tpu_torch.checkpoints import load_compact
from multi_speaker_tts_tpu_torch.data.datasets import BucketBatcher, PatternDataset
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
from multi_speaker_tts_tpu_torch.inference import _gl_vocode, prenet_mask_sampler, resolve_device
from multi_speaker_tts_tpu_torch.models.ge2e import GE2E
from multi_speaker_tts_tpu_torch.models.losses import tacotron_losses
from multi_speaker_tts_tpu_torch.models.speaker import SpeakerLUT
from multi_speaker_tts_tpu_torch.models.tacotron import Tacotron
from multi_speaker_tts_tpu_torch.ops.numerics import compute_dtype_of
from multi_speaker_tts_tpu_torch.parallel import multihost
from multi_speaker_tts_tpu_torch.train.checkpoints import CheckpointManager
from multi_speaker_tts_tpu_torch.train.logger import Logger, NullLogger
from multi_speaker_tts_tpu_torch.train.optim import OptState, global_norm, make_optimizer
from multi_speaker_tts_tpu_torch.weights import load_into, module_state, params_from_jax, random_init

_BATCH_KEYS = ("tokens", "token_lengths", "mels", "mel_lengths", "ref_mels", "spects",
               "speaker_ids")


def build_models(hp, compute_dtype) -> tuple[Tacotron, GE2E | None, SpeakerLUT | None]:
    """(Tacotron, the GE2E encoder or None, the speaker table or None)."""
    spk_type = hp.Speaker_Embedding.get("Type")
    if spk_type not in ("GE2E", "LUT", None):
        raise NotImplementedError(f"unknown Speaker_Embedding.Type {spk_type!r}")
    return (Tacotron(hp, compute_dtype),
            GE2E.from_hp(hp, compute_dtype) if spk_type == "GE2E" else None,
            SpeakerLUT.from_hp(hp) if spk_type == "LUT" else None)


def resolve_guided_attention(hp) -> tuple[float | None, float]:
    """(sigma, weight) as the objective uses them: (None, 0.0) when guided
    attention is off, so eval totals match train totals."""
    ga = hp.Train.get("Guided_Attention")
    if ga is not None and ga.Use:
        return ga.Sigma, ga.Weight
    return None, 0.0


class Trainer:
    """Teacher-forced training of the Tacotron (GE2E-, LUT- or
    un-conditioned) on one device a process. The weights are unset until
    :meth:`initialize` (or :meth:`from_params` / :meth:`from_compact`).

    ``n_devices`` is the JAX signature's mesh size: here it must equal the
    process group's size (1 without one), since the port trains
    data-parallel with one process a device; any other value raises."""

    def __init__(self, hp, checkpoint_dir: str | None = None, log_dir: str | None = None,
                 device=None, seed: int = 0, n_devices: int | None = None):
        self.device = resolve_device(device)
        self.hp = hp
        self.seed = seed
        self.process_count = multihost.checked_process_count(n_devices, hp.Train.Batch_Size,
                                                             "Train.Batch_Size")
        self.process_index = multihost.process_index()
        self.is_main = self.process_index == 0
        self.compute_dtype = compute_dtype_of(hp)
        self.tacotron, self.ge2e, self.speaker_lut = build_models(hp, self.compute_dtype)
        for m in self._modules().values():
            m.to(self.device)
        self.freeze_ge2e = bool(self.ge2e is not None
                                and hp.Speaker_Embedding.GE2E.get("Freeze", False))
        self.r = int(hp.Decoder.get("N_Frames_Per_Step", 1))
        self.ga_sigma, self.ga_weight = resolve_guided_attention(hp)
        named = [(f"{prefix}.{n}", t) for prefix, m in self._modules().items()
                 for n, t in m.named_parameters()]
        self.param_names = [n for n, _ in named]  # state keys, as weights.py names them
        self.params = [t for _, t in named]
        self.frozen = [self.freeze_ge2e and n.startswith("ge2e.") for n in self.param_names]
        self.optimizer = make_optimizer(hp)
        self.opt_state = self.optimizer.init(self.params)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.step = 0
        self.initialized = False
        self.checkpoint_dir = checkpoint_dir
        self.log_dir = log_dir
        self._checkpoints: CheckpointManager | None = None
        self._logger: Logger | None = None
        self.dsp_cfg = dsp.DSPConfig.from_hp(hp)
        # (start, stop) steps of a torch.profiler trace; None: off.
        self.profile_steps: tuple[int, int] | None = None

    def _modules(self) -> dict:
        mods = {"ge2e": self.ge2e, "speaker_lut": self.speaker_lut, "tacotron": self.tacotron}
        return {k: m for k, m in mods.items() if m is not None}

    @property
    def checkpoints(self) -> CheckpointManager | None:
        """The checkpoint directory's manager; None in processes other than
        the first of a data-parallel run."""
        if self._checkpoints is None and self.is_main:
            self._checkpoints = CheckpointManager(self.checkpoint_dir or self.hp.Checkpoint_Path)
        return self._checkpoints

    @property
    def logger(self) -> Logger:
        if self._logger is None:
            self._logger = (Logger if self.is_main else NullLogger)(
                self.log_dir or self.hp.Log_Path)
        return self._logger

    # -- weights -----------------------------------------------------------------
    def load_params(self, params: dict, batch_stats: dict) -> None:
        """Load JAX (params, batch_stats) numpy trees into the modules."""
        state = params_from_jax(params, batch_stats, self.hp)
        for prefix, m in self._modules().items():
            load_into(m, state, f"{prefix}.")
        self.initialized = True

    @classmethod
    def from_params(cls, hp, params: dict, batch_stats: dict, **kwargs) -> "Trainer":
        """A trainer from JAX (params, batch_stats) numpy trees, with a fresh
        optimizer state."""
        trainer = cls(hp, **kwargs)
        trainer.load_params(params, batch_stats)
        return trainer

    @classmethod
    def from_compact(cls, path, hp=None, **kwargs) -> "Trainer":
        """Load an ``export_compact`` checkpoint; hp from its ``meta["hp"]``
        unless given."""
        params, batch_stats, meta = load_compact(path)
        if hp is None:
            if "hp" not in meta:
                raise ValueError(f"{path} carries no hp; pass one explicitly")
            hp = Recursive_Parse(meta["hp"])
        return cls.from_params(hp, params, batch_stats, **kwargs)

    def initialize(self) -> None:
        """A fresh init from a CPU generator seeded with ``seed``; then the
        checkpoint directory's latest step, if it has one, or else the
        pretrained GE2E encoder that the hparams name. In a data-parallel
        run process 0 does this and broadcasts the state to the others."""
        random_init(self.hp, torch.Generator().manual_seed(self.seed), **self._modules())
        self.initialized = True
        if self.is_main:
            restored, step = self.checkpoints.restore()
            if restored is not None:
                self.load_state(restored)
                print(f"resumed from checkpoint step {step}")
            elif self.ge2e is not None:
                pre = self.hp.Speaker_Embedding.GE2E.get("Pretrained_Checkpoint")
                if pre:
                    self.load_pretrained_ge2e(pre)
        self.sync_state()

    def sync_state(self) -> None:
        """Give every process of a data-parallel run process 0's state:
        params, BatchNorm statistics, optimizer state, step and generator
        (a no-op alone). Every process passes a barrier first."""
        if self.process_count <= 1:
            return
        multihost.barrier("trainer_state")
        gen = self.generator.get_state()
        counters = torch.tensor([self.step, self.opt_state.count], dtype=torch.int64)
        multihost.broadcast_state([*self.params, *self.tacotron.buffers(), *self.opt_state.mu,
                                   *self.opt_state.nu, gen, counters])
        self.generator.set_state(gen)
        self.step = int(counters[0])
        self.opt_state = self.opt_state._replace(count=int(counters[1]))

    @torch.no_grad()
    def load_pretrained_ge2e(self, checkpoint_dir: str) -> None:
        """Graft the encoder of a GE2ETrainer checkpoint (shapes must match
        the Speaker_Embedding config)."""
        mgr = CheckpointManager(checkpoint_dir)
        restored, step = mgr.restore()
        if restored is None:
            raise FileNotFoundError(f"no GE2E checkpoint under {checkpoint_dir}")
        load_into(self.ge2e, {f"ge2e.{k}": v.numpy()
                              for k, v in restored["params"]["encoder"].items()}, "ge2e.")
        print(f"loaded pretrained GE2E encoder from step {step}")

    def bn_stats(self) -> list[torch.Tensor]:
        """The BatchNorm running statistics, in module order."""
        return [b for name, b in self.tacotron.named_buffers()
                if name.endswith(("bn_mean", "bn_var"))]

    def state(self) -> dict:
        """The flat ``ge2e.*`` / ``speaker_lut.*`` / ``tacotron.*`` state
        (numpy), as ``weights.params_to_jax`` reads it."""
        return module_state(**self._modules())

    def checkpoint_state(self) -> dict:
        """What a checkpoint holds: the step, the hparams, the params and
        BatchNorm statistics by state key, the optimizer state and the
        generator's state, on the CPU."""
        cpu = lambda t: t.detach().cpu().clone()  # noqa: E731
        buffers = {f"tacotron.{n}": cpu(b) for n, b in self.tacotron.named_buffers()}
        return {"step": self.step, "hp": self.hp.to_dict(),
                "params": {n: cpu(p) for n, p in zip(self.param_names, self.params)},
                "batch_stats": buffers,
                "opt_state": {"count": self.opt_state.count,
                              "mu": [cpu(m) for m in self.opt_state.mu],
                              "nu": [cpu(v) for v in self.opt_state.nu]},
                "generator": self.generator.get_state()}

    @torch.no_grad()
    def load_state(self, state: dict) -> None:
        """Restore :meth:`checkpoint_state`'s dict."""
        for n, p in zip(self.param_names, self.params):
            p.copy_(state["params"][n])
        for n, b in self.tacotron.named_buffers():
            b.copy_(state["batch_stats"][f"tacotron.{n}"])
        o = state["opt_state"]
        self.opt_state = OptState(int(o["count"]), [m.to(self.device) for m in o["mu"]],
                                  [v.to(self.device) for v in o["nu"]])
        self.generator.set_state(state["generator"])
        self.step = int(state["step"])
        self.initialized = True

    def save(self, step: int | None = None) -> None:
        """Write a checkpoint (process 0 of a data-parallel run only)."""
        if self.is_main:
            self.checkpoints.save(self.step if step is None else step, self.checkpoint_state())

    # -- one step ----------------------------------------------------------------
    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(batch[k]).to(self.device) for k in _BATCH_KEYS if k in batch}

    def _speaker_embedding(self, batch: dict):
        if self.speaker_lut is not None:
            return self.speaker_lut(batch["speaker_ids"].long())
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

    def _forward_backward(self, batch: dict):
        """Train-mode forward on a device batch -> (losses, gradients in
        ``self.params`` order; zeros where none flows), both summed over the
        processes of a data-parallel run: the global batch's."""
        outputs = self.tacotron(batch["tokens"], batch["token_lengths"], batch["mels"],
                                self._speaker_embedding(batch), train=True,
                                generator=self.generator)
        losses = self._losses(batch, outputs)
        grads = torch.autograd.grad(losses["total"], self.params, allow_unused=True)
        grads = multihost.all_reduce_sum([torch.zeros_like(p) if g is None else g
                                          for p, g in zip(self.params, grads)])
        return _global_losses(losses), grads

    def gradients(self, batch: dict) -> tuple[dict, dict]:
        """The train step's forward and backward without the update ->
        (losses as floats, ``{state key: gradient}`` as numpy). The forward
        is in train mode, so it moves the BatchNorm running statistics.
        ``batch`` is this process's rows of the global batch."""
        losses, grads = self._forward_backward(self._to_device(batch))
        return ({k: float(v) for k, v in losses.items()},
                {n: g.detach().cpu().numpy() for n, g in zip(self.param_names, grads)})

    def train_step(self, batch: dict) -> dict:
        """One teacher-forced step on this process's rows of the global
        batch -> metrics of the global batch: ``total``, each loss,
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
        metrics = {k: float(v) for k, v in losses.items()}
        metrics["grad_norm"] = float(grad_norm)
        metrics["skipped_nonfinite"] = 0.0 if finite else 1.0
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: dict, prenet_masks=None) -> tuple[dict, dict]:
        """Teacher-forced evaluation -> (losses of the global batch as
        floats, this process's outputs): running BatchNorm statistics, no
        conv dropout, the prenet still stochastic (its masks
        ``prenet_masks``, else drawn from the trainer's generator)."""
        batch = self._to_device(batch)
        outputs = self.tacotron(batch["tokens"], batch["token_lengths"], batch["mels"],
                                self._speaker_embedding(batch), train=False,
                                generator=self.generator, prenet_masks=prenet_masks)
        return ({k: float(v) for k, v in _global_losses(self._losses(batch, outputs)).items()},
                outputs)

    # -- the loop ----------------------------------------------------------------
    def make_batcher(self, pattern_dir: str, shuffle: bool = True) -> BucketBatcher:
        hp = self.hp
        lh = hp.get("Linear_Head")
        return BucketBatcher(
            PatternDataset(pattern_dir), batch_size=hp.Train.Batch_Size,
            token_buckets=list(hp.Train.Batch_Bucketing.Token_Buckets),
            mel_buckets=list(hp.Train.Batch_Bucketing.Mel_Buckets),
            mel_dim=hp.Sound.Mel_Dim, n_frames_per_step=self.r,
            ref_window=hp.Speaker_Embedding.GE2E.Window_Length if self.ge2e is not None else None,
            shuffle=shuffle,
            spect_dim=hp.Sound.Spectrogram_Dim if (lh is not None and lh.Use) else None)

    def _local_rows(self, batch: dict) -> dict:
        """This process's contiguous rows of a global batch."""
        rows = multihost.local_rows(len(batch["tokens"]))
        return {k: v[rows] for k, v in batch.items()}

    def _batches(self, batcher: BucketBatcher):
        """Endless training batches, this process's rows of each: from one
        long-lived loader with ``Train.Num_Workers`` > 0 (which collates only
        those rows), else the in-process batcher epoch by epoch
        (``Accumulated_Dataset_Epoch`` passes a reshuffle; every process
        draws the same global batch and keeps its rows)."""
        hp = self.hp
        n_workers = hp.Train.get("Num_Workers", 0) or 0
        if n_workers > 0:
            from multi_speaker_tts_tpu_torch.data.loader import make_loader

            for batch in make_loader(batcher, num_workers=n_workers,
                                     shard_index=self.process_index,
                                     shard_count=self.process_count):
                batch.pop("bucket", None)
                yield batch
        tp = hp.Train.get("Train_Pattern")
        accumulated = int(tp.get("Accumulated_Dataset_Epoch", 1)) if tp else 1
        while True:
            for _ in range(accumulated):
                for _, batch in batcher:
                    yield self._local_rows(batch)

    def train(self, pattern_dir: str, eval_pattern_dir: str | None = None,
              max_steps: int | None = None) -> dict:
        """Step to ``max_steps`` (``Train.Max_Step`` when None) from where the
        trainer stands (a resumed checkpoint's step), then save. Returns the
        last step's metrics."""
        hp = self.hp
        max_steps = max_steps or hp.Train.Max_Step
        batcher = self.make_batcher(pattern_dir)
        if not batcher.assignment:
            raise ValueError(f"no pattern of {pattern_dir} fits the batch buckets (tokens "
                             f"{batcher.token_buckets}, mels {batcher.mel_buckets})")
        if not self.initialized:
            self.initialize()
        t_last, frames_since, metrics, prof = time.time(), 0, {}, None
        synced = self.process_count <= 1
        if self.step < max_steps:
            for batch in self._batches(batcher):
                if not synced:  # every loader is up: meet before the first step
                    multihost.barrier("first_batch")
                    synced = True
                if self.is_main and self.profile_steps and self.step == self.profile_steps[0]:
                    prof = _start_profile()
                metrics = self.train_step(batch)
                if prof is not None and self.step == self.profile_steps[1]:
                    _stop_profile(prof, self.logger.log_dir / "profile")
                    prof = None
                frames_since += int(np.asarray(batch["mel_lengths"]).sum())
                step = self.step
                if step % hp.Train.Logging_Interval == 0:
                    dt = max(time.time() - t_last, 1e-9)
                    print(f"step {step}: loss {metrics['total']:.7g} "
                          f"({frames_since / dt:,.0f} mel frames/s)", flush=True)
                    self.logger.add_scalar_dict("Train/Loss", metrics, step)
                    self.logger.add_scalar("Train/Learning_Rate",
                                           self.optimizer.schedule(step), step)
                    self.logger.add_scalar("Train/Mel_Frames_Per_Sec", frames_since / dt, step)
                    t_last, frames_since = time.time(), 0
                if step % hp.Train.Checkpoint_Save_Interval == 0:
                    self.save(step)
                if eval_pattern_dir is not None and step % hp.Train.Evaluation_Interval == 0:
                    self.evaluate(eval_pattern_dir, step)
                if (eval_pattern_dir is not None and self.is_main
                        and step % hp.Train.get("Inference_Interval", 10 ** 9) == 0):
                    self.inference_step(eval_pattern_dir, step)
                if step >= max_steps:
                    break
        if prof is not None:
            _stop_profile(prof, self.logger.log_dir / "profile")
        self.save(self.step)
        self.logger.flush()
        return metrics

    def evaluate(self, pattern_dir: str, step: int, max_batches: int = 8) -> dict:
        """Mean teacher-forced losses over up to ``max_batches`` batches,
        logged with the first row's alignment (every process of a
        data-parallel run takes part; process 0 logs)."""
        totals: dict[str, float] = {}
        count, outputs = 0, None
        for _, batch in self.make_batcher(pattern_dir, shuffle=False):
            if count >= max_batches:
                break
            losses, outputs = self.eval_step(self._local_rows(batch))
            for k, v in losses.items():
                totals[k] = totals.get(k, 0.0) + v
            count += 1
        if not count:
            return {}
        means = {k: v / count for k, v in totals.items()}
        self.logger.add_scalar_dict("Evaluation/Loss", means, step)
        align = outputs["alignments"][0].float().cpu().numpy()
        self.logger.add_image("Evaluation/Alignment", align / max(align.max(), 1e-6), step)
        return means

    @torch.no_grad()
    def inference_step(self, pattern_dir: str, step: int) -> None:
        """AR-synthesize one eval batch with the current weights and log the
        first row's alignment (zeros past the decode chunk the row stopped
        in) and audio (process 0 of a data-parallel run alone: the AR decode
        has no collective)."""
        hp, cfg = self.hp, self.dsp_cfg
        try:
            _, batch = next(iter(self.make_batcher(pattern_dir, shuffle=False)))
        except StopIteration:
            return
        batch = self._to_device(batch)
        max_steps = min(hp.Decoder.Max_Step, int(batch["mels"].shape[1]) * 2)
        out = self.tacotron.infer(
            batch["tokens"], batch["token_lengths"], self._speaker_embedding(batch), max_steps,
            hp.Decoder.Stop_Threshold,
            prenet_masks=prenet_mask_sampler(hp, self.device, self.seed + step,
                                             batch["tokens"].shape[0]))
        align = out["alignments"][0].float().cpu().numpy()
        self.logger.add_image("Inference/Alignment", align / max(align.max(), 1e-6), step)
        if "linear" in out and cfg.n_fft % cfg.hop == 0:
            wav = _gl_vocode(out["linear"][:1], out["mel_post"][:1], cfg, False)[0]
            T = int(out["mel_lengths"][0])
            self.logger.add_audio("Inference/Audio", wav[:max(T - 1, 1) * cfg.hop].cpu().numpy(),
                                  step, cfg.sample_rate)


def _global_losses(losses: dict) -> dict:
    """Each loss summed over the processes (their shares add up to the
    global batch's loss), detached."""
    keys = list(losses)
    summed = multihost.all_reduce_sum([torch.stack([losses[k].detach() for k in keys])])[0]
    return dict(zip(keys, summed))


def _start_profile():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profile(prof, out_dir: pathlib.Path) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "trace.json"))
    print(f"profile of the traced steps written to {out_dir / 'trace.json'}")
