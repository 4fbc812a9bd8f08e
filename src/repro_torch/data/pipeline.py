"""Deterministic synthetic token pipeline (counterpart of
``repro/data/pipeline.py``).

Stateless in the step: ``batch_at(cfg, step)`` is a pure function of
(seed, step, shape), so a resumed run sees the same batches with no
iterator state to checkpoint, and each data-parallel rank can slice its
part (``host_slice``). The tokens are the reference's, value for value:
the same threefry stream (``core/prng.py``), Zipf-ish draws through
``u ** (-1 / (alpha - 1))`` (float32, within an ulp of XLA's ``power``;
no token differs at the tested sizes) and the same bigram structure at
even positions.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_alpha: float = 1.1


def _zipf_tokens(key, shape, vocab, alpha):
    n = shape[0] * shape[1]
    u = prng.uniform(key, n, minval=1e-6, maxval=1.0).reshape(shape)
    # inverse-CDF approximation of a Zipf over [0, vocab)
    ranks = torch.pow(u, -1.0 / (alpha - 1.0)) - 1.0
    # the reference's int32 cast saturates and is then clipped to
    # [0, vocab - 1]; clamping the float first gives the same integers
    return torch.clamp(ranks, 0.0, float(vocab - 1)).to(torch.int32)


def batch_at(cfg: DataConfig, step: int, device=None) -> dict:
    """The global batch of ``step`` on ``device`` (CUDA unless given):
    ``tokens`` and the next-token ``targets``, (global_batch, seq_len)
    int32."""
    dev = resolve_device(device)
    key = prng.fold_in(prng.key(cfg.seed, device=dev), step)
    k1, _ = prng.split(key)
    B, T = cfg.global_batch, cfg.seq_len
    toks = _zipf_tokens(k1, (B, T + 1), cfg.vocab, cfg.zipf_alpha)
    # learnable bigram structure: every even position repeats the
    # previous token with a fixed offset
    pos = torch.arange(T + 1, device=dev)
    prev = torch.roll(toks, 1, dims=1)
    structured = torch.where(pos[None, :] % 2 == 0,
                             (prev * 31 + 7) % cfg.vocab, toks)
    return {"tokens": structured[:, :-1], "targets": structured[:, 1:]}


def host_slice(batch: dict, rank: int, n_ranks: int) -> dict:
    """The per-host slice of a global batch (multi-host deployment)."""
    def sl(x):
        per = x.shape[0] // n_ranks
        return x[rank * per:(rank + 1) * per]
    return {k: sl(v) for k, v in batch.items()}
