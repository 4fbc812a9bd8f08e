"""Continuous batching for decode serving (counterpart of
``repro/serving/batcher.py``).

A fixed pool of ``n_slots`` decode slots shares one decode step (the
cache is allocated once at ``max_len``). Requests are admitted into free
slots as they arrive (a single-request prefill is written into the
slot's cache region), every decode tick advances all slots in lock-step
with a per-slot position vector, and finished slots (EOS or length
budget) are freed at once for the next queued request.

``idle_fraction()`` reports how often the pool had no live slot: the
node-level LC/DC gating window. Prefill and decode run through
``kernels.ops.model_kernel_fns()``: on the card the attention and wkv
kernels, on the CPU their plain versions.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.kernels import ops
from repro_torch.models import model as M


@dataclass
class Request:
    rid: int
    tokens: list                      # prompt token ids
    max_new: int = 16
    out: list = field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    def __init__(self, cfg, params, *, n_slots: int = 4,
                 max_len: int = 128, eos_id: int | None = None):
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        dev = params["embed"].device
        self.device = dev
        self.cache = M.init_cache(cfg, n_slots, max_len, dtype=cfg.dtype,
                                  device=dev)
        self.pos = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self.last_tok = torch.zeros((n_slots, 1), dtype=torch.long,
                                    device=dev)
        self.slot_req: list[Request | None] = [None] * n_slots
        self.queue: list[Request] = []
        self.ticks = 0
        self.idle_ticks = 0
        self.prefills = 0
        self.decode_steps = 0
        self.kernel_fns = ops.model_kernel_fns()

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for s in range(self.n_slots):
            if self.slot_req[s] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            toks = torch.tensor([req.tokens], dtype=torch.long,
                                device=self.device)
            logits, pre_cache = M.prefill(self.cfg, self.params,
                                          {"tokens": toks},
                                          kernel_fns=self.kernel_fns)
            self.prefills += 1
            M.write_cache(self.cache, pre_cache, slice(s, s + 1))
            nxt = int(torch.argmax(logits[0]))
            req.out.append(nxt)
            self.slot_req[s] = req
            self.pos[s] = len(req.tokens)
            self.last_tok[s, 0] = nxt

    # -- decode loop --------------------------------------------------------
    def step(self):
        """One lock-step decode tick over all slots."""
        self._admit()
        self.ticks += 1
        live = [s for s in range(self.n_slots)
                if self.slot_req[s] is not None]
        if not live:
            self.idle_ticks += 1
            return 0
        logits, self.cache = M.decode_step(self.cfg, self.params,
                                           self.cache, self.last_tok,
                                           self.pos,
                                           kernel_fns=self.kernel_fns)
        self.decode_steps += 1
        nxt = torch.argmax(logits, dim=-1)
        self.pos = self.pos + 1
        self.last_tok = nxt[:, None]
        toks, pos = nxt.tolist(), self.pos.tolist()
        emitted = 0
        for s in live:
            req = self.slot_req[s]
            tok = toks[s]
            req.out.append(tok)
            emitted += 1
            length_done = len(req.out) >= req.max_new
            eos_done = self.eos_id is not None and tok == self.eos_id
            full = pos[s] >= self.max_len - 1
            if length_done or eos_done or full:
                req.done = True
                self.slot_req[s] = None     # slot freed for the queue
        return emitted

    def run(self, max_ticks: int = 1000):
        """Steps until the queue and every slot are empty, or for
        ``max_ticks`` ticks in all."""
        while self.ticks < max_ticks and \
                (self.queue or any(self.slot_req)):
            self.step()

    def idle_fraction(self) -> float:
        return self.idle_ticks / max(self.ticks, 1)
