"""Optimizers and schedules (counterpart of ``repro/optim``)."""
from __future__ import annotations

import functools

from repro_torch.optim.adafactor import adafactor_init, adafactor_update
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_warmup


def make_optimizer(cfg):
    """Returns (init_fn(params), update_fn(grads, state, params, lr)).
    Adafactor groups the per-layer leaves as the reference stacks them
    (``models.model.stack_plan``)."""
    if cfg.optimizer == "adafactor":
        from repro_torch.models.model import stack_plan
        plan = stack_plan(cfg)
        return (functools.partial(adafactor_init, plan=plan),
                functools.partial(adafactor_update, plan=plan))
    return adamw_init, adamw_update


__all__ = ["adamw_init", "adamw_update", "adafactor_init",
           "adafactor_update", "cosine_warmup", "make_optimizer"]
