"""Optional pipeline parallelism (counterpart of
``repro/distributed/pipeline.py``): a microbatched GPipe-style stage
executor on torch.distributed.

The stage axis is any mesh axis: stage s holds slice s of the stacked
parameters. Microbatches stream through; activations hop one stage a
tick with ``ppermute`` (``batch_isend_irecv`` on the stage group). The
bubble share is (S - 1) / (M + S - 1). Every rank runs the reference's
``shard_map`` body: ticks of inject (stage 0 takes microbatch t), compute,
bank (the last stage keeps its result at t - (S - 1)) and ppermute,
then a ``psum`` over the stage axis broadcasts the last stage's outputs
(every other stage banked zeros).
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from repro_torch.core.tree import tree_map
from repro_torch.distributed import collectives as C


def pipeline_apply(mesh, stage_axis: str, n_stages: int, layer_fn,
                   stacked_params, x, n_micro: int):
    """Run x (B, ...) through ``n_stages`` stages of ``layer_fn(params,
    x)`` on this rank's stage of ``mesh`` (a ``DeviceMesh`` with axis
    ``stage_axis`` of ``n_stages`` ranks).

    stacked_params: a tree whose leaves have a leading dim of
    ``n_stages`` (this rank uses its slice). ``x`` is the whole input
    on every rank, consumed microbatch by microbatch (B % n_micro ==
    0). Returns the last stage's output, in the original batch order,
    on every rank."""
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"pipeline_apply: batch {B} does not divide into "
                         f"{n_micro} microbatches")
    on = SimpleNamespace(mesh=mesh)
    if C.axes_size(on, stage_axis) != n_stages:
        raise ValueError(f"pipeline_apply: axis {stage_axis!r} has "
                         f"{C.axes_size(on, stage_axis)} ranks, not "
                         f"{n_stages} stages")
    s = C.axis_index(on, stage_axis)
    params = tree_map(lambda a: a[s], stacked_params)
    xm = x.reshape(n_micro, B // n_micro, *x.shape[1:])
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    buf = torch.zeros_like(xm[0])
    outs = [torch.zeros_like(xm[0]) for _ in range(n_micro)]
    for t in range(n_micro + n_stages - 1):
        cur = xm[min(t, n_micro - 1)] if s == 0 else buf
        y = layer_fn(params, cur)
        if s == n_stages - 1 and t >= n_stages - 1:
            outs[t - (n_stages - 1)] = y
        buf = C.ppermute(y, on, stage_axis, perm)
    out = C.psum(torch.stack(outs), on, stage_axis)
    return out.reshape(B, *x.shape[1:])
