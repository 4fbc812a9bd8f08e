"""Training launcher (counterpart of ``repro/launch/train.py``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
      --steps 1000 --ckpt-dir /ckpts/qwen3-8b [--reduced] [--device cpu]

One process on one device, the CUDA card unless ``--device`` says
otherwise; ``--reduced`` takes the tiny same-family config (a CPU
smoke run). The reference builds a production mesh without
``--reduced``; the port trains on one card, and ``--multi-pod`` waits
for the distributed slice (ROADMAP Queue 1 item 13f).
"""
import argparse

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.data.pipeline import DataConfig
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod: the production mesh is not ported yet (ROADMAP "
            "Queue 1 item 13f); the port trains on one device")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    data = DataConfig(vocab=cfg.vocab,
                      seq_len=args.seq_len or (64 if args.reduced else 4096),
                      global_batch=args.global_batch
                      or (8 if args.reduced else 256))
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, total_steps=args.steps,
                         ckpt_every=args.ckpt_every, peak_lr=args.lr)
    trainer = Trainer(cfg=cfg, tcfg=tcfg, data=data, device=args.device)
    state, start = trainer.restore_or_init()
    print(f"training {cfg.name} from step {start} on 1 device(s)")
    trainer.run(state, start)
    print("done; losses:",
          [round(m["loss"], 4) for m in trainer.metrics_log[-5:]])
    return trainer


if __name__ == "__main__":
    main()
