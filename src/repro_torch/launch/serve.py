"""Serving launcher: batched prefill + lock-step greedy decode
(counterpart of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
      --batch 8 --prompt-len 256 --gen 32                 # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
      --reduced --device cpu

Random weights from ``--seed``, random prompt tokens from a numpy
generator with the same seed. Attention and wkv run through
``kernels.ops.model_kernel_fns()``: the CUDA kernels on the card, their
plain versions on the CPU. Prints prefill and decode tokens/s.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import model as M


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg, params, prompts, gen, kernel_fns=None) -> dict:
    """Greedy generation of ``gen`` tokens for each row of ``prompts``
    (B, P): one batched prefill, then gen - 1 lock-step decode steps
    over a cache of P + gen positions. Returns the tokens (B, gen) and
    the prefill and decode times (the device synchronised) and rates."""
    dev = prompts.device
    B, P = prompts.shape
    max_len = P + gen
    _sync(dev)
    t0 = time.perf_counter()
    logits, pre = M.prefill(cfg, params, {"tokens": prompts},
                            kernel_fns=kernel_fns)
    tok = torch.argmax(logits, dim=-1)[:, None]
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    cache = M.init_cache(cfg, B, max_len, dtype=cfg.dtype, device=dev)
    M.write_cache(cache, pre)
    out = [tok]
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(P, max_len - 1):
        pos = torch.full((B,), t, dtype=torch.int32, device=dev)
        logits, cache = M.decode_step(cfg, params, cache, tok, pos,
                                      kernel_fns=kernel_fns)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    n_dec = B * (gen - 1)
    return {"tokens": torch.cat(out, dim=1), "prefill_s": prefill_s,
            "decode_s": decode_s, "prefill_tok_s": B * P / prefill_s,
            "decode_tok_s": n_dec / decode_s if n_dec else 0.0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    params = M.init_params(cfg, args.seed, device=dev)
    prompts = torch.as_tensor(np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (args.batch, args.prompt_len)), device=dev)
    res = generate(cfg, params, prompts, args.gen,
                   kernel_fns=ops.model_kernel_fns())
    print(f"{cfg.name} on {dev}: batch {args.batch}, prompt "
          f"{args.prompt_len}, gen {args.gen}: prefill "
          f"{res['prefill_tok_s']:.1f} tok/s ({res['prefill_s']:.3f} s), "
          f"decode {res['decode_tok_s']:.1f} tok/s "
          f"({res['decode_s']:.3f} s)")
    return res


if __name__ == "__main__":
    main()
