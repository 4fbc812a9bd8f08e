"""Quickstart on the PyTorch/CUDA port: train a tiny LM for 20 steps,
then greedy-decode from it.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

It runs on the CUDA device (attention through the hand-written flash
kernels, forward and backward); without one it stops with an error,
unless ``--device cpu`` is given (the kernels' plain versions).
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.optim import make_optimizer
from repro_torch.train.steps import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b")), vocab=512)
    data = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)
    fns = ops.model_kernel_fns()

    params = M.init_params(cfg, 0, device=dev)
    opt_init, _ = make_optimizer(cfg)
    opt = opt_init(params)
    step = make_train_step(cfg, kernel_fns=fns, peak_lr=3e-3, warmup=5)

    n_params = sum(p.numel() for p in leaves(params))
    print(f"training {cfg.name}-reduced ({n_params / 1e6:.1f}M params) "
          f"on {dev}")
    losses = []
    for i in range(20):
        params, opt, m = step(params, opt, batch_at(data, i, device=dev), i)
        losses.append(float(m["loss"]))
        if i % 5 == 0 or i == 19:
            print(f"  step {i:3d} loss={losses[-1]:.4f} "
                  f"lr={float(m['lr']):.2e}")

    # greedy decode 12 tokens from a prompt
    prompt = batch_at(data, 10_000, device=dev)["tokens"][:1, :16]
    logits, pre = M.prefill(cfg, params, {"tokens": prompt}, kernel_fns=fns)
    cache = M.init_cache(cfg, 1, 16 + 12, dtype=cfg.dtype, device=dev)
    M.write_cache(cache, pre)
    tok = torch.argmax(logits, -1)[:, None]
    out = [int(tok[0, 0])]
    for t in range(16, 16 + 11):
        logits, cache = M.decode_step(
            cfg, params, cache, tok,
            torch.full((1,), t, dtype=torch.int32, device=dev),
            kernel_fns=fns)
        tok = torch.argmax(logits, -1)[:, None]
        out.append(int(tok[0, 0]))
    print("prompt tokens: ", prompt[0].tolist())
    print("decoded tokens:", out)
    return {"losses": losses, "prompt": prompt[0].tolist(), "decoded": out}


if __name__ == "__main__":
    main()
