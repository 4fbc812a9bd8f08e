"""Training launcher (counterpart of ``repro/launch/train.py``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
      --steps 1000 --ckpt-dir /ckpts/qwen3-8b [--reduced] [--device cpu]
  torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
      --arch qwen3-8b --steps 1000 --ckpt-dir /ckpts/qwen3-8b [--multi-pod]

A plain process, or ``--reduced`` (the tiny same-family config, a CPU
smoke run), trains on one device: the CUDA card unless ``--device``
says otherwise. Under ``torchrun`` (``WORLD_SIZE`` set) without
``--reduced`` each process is one rank of the production mesh, as the
reference's launcher builds it: 16 x 16 ('data', 'model'), or with
``--multi-pod`` 2 x 16 x 16 ('pod', 'data', 'model'); the world must
have 256 (512) ranks, else a ``ValueError`` names its size. Ranks use
NCCL on ``cuda:<LOCAL_RANK>``, gloo with ``--device cpu``.
"""
import argparse
import os

import torch.distributed as tdist

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import (dist_for, make_production_mesh,
                                     world_size)
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU smoke)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card; "
                    "cuda:<LOCAL_RANK> under torchrun)")
    args = ap.parse_args(argv)

    dist = None
    if not args.reduced and (args.multi_pod or "WORLD_SIZE" in os.environ):
        need = 512 if args.multi_pod else 256
        if world_size() != need:
            raise ValueError(
                f"the production mesh{' (--multi-pod)' * args.multi_pod} "
                f"needs a world of {need} ranks; this one has "
                f"{world_size()} (run it under torchrun)")
        if not tdist.is_initialized():
            tdist.init_process_group(
                "gloo" if args.device == "cpu" else "nccl",
                init_method="env://")
        dist = dist_for(make_production_mesh(multi_pod=args.multi_pod))

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    data = DataConfig(vocab=cfg.vocab,
                      seq_len=args.seq_len or (64 if args.reduced else 4096),
                      global_batch=args.global_batch
                      or (8 if args.reduced else 256))
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, total_steps=args.steps,
                         ckpt_every=args.ckpt_every, peak_lr=args.lr)
    device = args.device or ("cuda" if dist is None else None)
    trainer = Trainer(cfg=cfg, tcfg=tcfg, data=data, dist=dist,
                      device=device)
    state, start = trainer.restore_or_init()
    print(f"training {cfg.name} from step {start} on "
          f"{world_size() if dist is not None else 1} device(s)")
    trainer.run(state, start)
    print("done; losses:",
          [round(m["loss"], 4) for m in trainer.metrics_log[-5:]])
    return trainer


if __name__ == "__main__":
    main()
