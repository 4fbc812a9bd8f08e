"""End-to-end training on the PyTorch/CUDA port: train a ~100M-param
qwen3-family model with the full production stack — deterministic data
pipeline, AdamW + cosine schedule, async atomic checkpoints,
restart-safe resume, straggler tracking.

  PYTHONPATH=src python examples/torch_train_100m.py --steps 300
  # kill it mid-run and run again: it resumes from the last checkpoint.

It runs on the CUDA device (attention through the hand-written flash
kernels, forward and backward); ``--device cpu`` runs it on the CPU,
where each step takes a few seconds. The config is a genuine ~100M
parameter model (12L x 768, GQA 12/4, tied embeddings, 32k vocab), in
float32 as the reference's. Checkpoints go to ``--ckpt-dir`` (by
default results/checkpoints/torch_train_100m under the repository).
"""
import argparse
import dataclasses
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

CKPT_DIR = Path(__file__).resolve().parents[1] / "results" / "checkpoints" \
    / "torch_train_100m"


def config_100m():
    base = get_config("qwen3-0.6b")
    return dataclasses.replace(
        base, name="qwen3-100m", n_layers=12, d_model=768, n_heads=12,
        n_kv=4, d_head=64, d_ff=2048, vocab=32000, qk_norm=True,
        tie_embeddings=True, dtype=torch.float32, remat=False,
        fsdp=False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = config_100m()
    n = cfg.n_params()
    print(f"model: {cfg.name}  ~{n/1e6:.0f}M params")
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, total_steps=args.steps,
                         ckpt_every=25, log_every=10, peak_lr=args.lr)
    trainer = Trainer(cfg=cfg, tcfg=tcfg, data=data, device=args.device)
    state, start = trainer.restore_or_init()
    if start:
        print(f"resuming from checkpoint at step {start}")
    trainer.run(state, start)
    ms = trainer.metrics_log
    print(f"\ntrained steps {start}..{args.steps - 1}")
    if ms:
        print(f"loss: first={ms[0]['loss']:.4f} last={ms[-1]['loss']:.4f}")
        print(f"mean step time: "
              f"{sum(m['step_time_s'] for m in ms)/len(ms):.2f}s; "
              f"stragglers flagged: {ms[-1]['stragglers_total']}")
    return {"start": start, "metrics": ms}


if __name__ == "__main__":
    main()
