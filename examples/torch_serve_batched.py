"""Batched serving demo on the PyTorch/CUDA port: prefill a batch of
prompts, then decode them in lock-step (the decode_32k cell in
miniature).

  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]

It runs on the CUDA device (attention through the hand-written flash
kernel); ``--device cpu`` runs the kernels' plain versions. Generation
is ``launch.serve.generate``: one batched prefill, its cache written
into the full-length one with ``write_cache`` (the reference example's
``merge``), then greedy lock-step decode.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import model as M


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = reduced(get_config("qwen3-8b"))
    params = M.init_params(cfg, 0, device=dev)

    B, prompt_len, gen_len = 8, 24, 16
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, prompt_len)), device=dev)

    res = serve.generate(cfg, params, prompts, gen_len,
                         kernel_fns=ops.model_kernel_fns())
    print(f"prefill {B}x{prompt_len} in {res['prefill_s']:.2f}s")
    out = res["tokens"]
    n_tok = out.numel()
    print(f"decoded {out.shape[1]} steps x {B} streams ({n_tok} tokens) "
          f"in {res['decode_s']:.2f}s -> {n_tok / res['decode_s']:.1f} "
          f"tok/s on {dev}")
    for b in range(min(B, 3)):
        print(f"stream {b}: {out[b].tolist()}")
    return {"cfg": cfg, "params": params, "prompts": prompts, "tokens": out}


if __name__ == "__main__":
    main()
