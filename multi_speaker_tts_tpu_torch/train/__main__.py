"""Training CLI (port of ``python -m multi_speaker_tts_tpu.train``):

    python -m multi_speaker_tts_tpu_torch.train -mode ge2e -train_pattern DIR \
        -checkpoint GE2E_DIR -max_step N
    python -m multi_speaker_tts_tpu_torch.train -mode tts -train_pattern DIR \
        -ge2e_checkpoint GE2E_DIR -checkpoint TTS_DIR [-eval_pattern DIR] [-max_step N]

``-hp`` reads a YAML file (needs pyyaml) or the same tree as JSON; without
it the shipped defaults apply. ``-debug_nans`` raises at the first module
whose output, forward or backward, holds a NaN or an infinity
(:mod:`.debug_nans`). Runs on the card unless ``-device cpu``. Data-parallel training runs
one process a device, each started with the same arguments plus its id::

    python -m multi_speaker_tts_tpu_torch.train ... -distributed \
        -coordinator 127.0.0.1:PORT -num_processes 2 -process_id {0,1}

(process i on ``cuda:i`` over NCCL, or on the CPU over gloo with ``-device
cpu``; ``-coordinator`` also takes a ``file://`` URL). Across hosts
``-process_id`` is the global rank and each process takes the card of its
rank on its host: ``-local_rank`` (and ``-local_processes``, the processes
on that host), or a launcher's ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``; two
hosts of 8 cards::

    python -m multi_speaker_tts_tpu_torch.train ... -distributed \
        -coordinator HOST0:PORT -num_processes 16 -process_id {8 h + i} \
        -local_rank {i} -local_processes 8

Process 0 of the world writes the checkpoints and logs.
"""

from __future__ import annotations

import argparse

from multi_speaker_tts_tpu_torch.parallel import multihost
from multi_speaker_tts_tpu_torch.train import debug_nans


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Train the TTS stack on a CUDA card")
    parser.add_argument("-hp", "--hyper_parameters", default=None)
    parser.add_argument("-mode", choices=["tts", "ge2e"], default="tts")
    parser.add_argument("-train_pattern", default=None)
    parser.add_argument("-eval_pattern", default=None)
    parser.add_argument("-checkpoint", default=None)
    parser.add_argument("-log", default=None)
    parser.add_argument("-max_step", type=int, default=None)
    parser.add_argument("-ge2e_checkpoint", default=None,
                        help="pretrained GE2E checkpoint dir (SV2TTS recipe)")
    parser.add_argument("-freeze_ge2e", action="store_true")
    parser.add_argument("-profile", action="store_true",
                        help="capture a torch.profiler trace of steps 10-20")
    parser.add_argument("-debug_nans", action="store_true",
                        help="raise at the first non-finite output of a module, forward or "
                             "backward, naming it")
    parser.add_argument("-device", default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    parser.add_argument("-distributed", action="store_true",
                        help="data-parallel training: join the process group first")
    parser.add_argument("-coordinator", default=None,
                        help="process 0's host:port (or a file:// URL)")
    parser.add_argument("-num_processes", type=int, default=None)
    parser.add_argument("-process_id", type=int, default=None,
                        help="this process's global rank")
    parser.add_argument("-local_rank", type=int, default=None,
                        help="this process's rank on its host: its card (default: LOCAL_RANK, "
                             "else one host)")
    parser.add_argument("-local_processes", type=int, default=None,
                        help="processes on this host (default: LOCAL_WORLD_SIZE)")
    args = parser.parse_args(argv)
    device = args.device
    if args.distributed:
        device = multihost.initialize_distributed(
            args.coordinator, args.num_processes, args.process_id, device=args.device,
            local_rank=args.local_rank, local_processes=args.local_processes)
        rank, here = multihost.local_rank()
        print(f"distributed: process {multihost.process_index()}/{multihost.process_count()} "
              f"on {device} (local rank {rank} of {here} on this host)", flush=True)

    from multi_speaker_tts_tpu_torch.hparams import load_hyper_parameters

    hp = load_hyper_parameters(args.hyper_parameters)
    if args.ge2e_checkpoint or args.freeze_ge2e:
        hp = hp.replace(Speaker_Embedding={"GE2E": {
            **({"Pretrained_Checkpoint": args.ge2e_checkpoint} if args.ge2e_checkpoint else {}),
            **({"Freeze": True} if args.freeze_ge2e else {}),
        }})
    try:
        _train(args, hp, device)
    finally:
        if args.distributed:
            multihost.shutdown()


def _train(args, hp, device) -> None:
    train_dir = args.train_pattern or hp.Train.Train_Pattern.Path

    if args.mode == "ge2e":
        from multi_speaker_tts_tpu_torch.train.ge2e_trainer import GE2ETrainer

        trainer = GE2ETrainer(hp, checkpoint_dir=args.checkpoint, log_dir=args.log,
                              device=device)
        if args.debug_nans:
            debug_nans.install(debug_nans.trainer_models(trainer))
        trainer.train(train_dir, max_steps=args.max_step or hp.Train.Max_Step)
        return

    from multi_speaker_tts_tpu_torch.train.trainer import Trainer

    trainer = Trainer(hp, checkpoint_dir=args.checkpoint, log_dir=args.log, device=device)
    if args.debug_nans:
        debug_nans.install(debug_nans.trainer_models(trainer))
    if args.profile:
        trainer.profile_steps = (10, 20)
    trainer.train(train_dir, eval_pattern_dir=args.eval_pattern or hp.Train.Eval_Pattern.get("Path"),
                  max_steps=args.max_step)


if __name__ == "__main__":
    main()
