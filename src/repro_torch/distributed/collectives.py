"""Collectives over the named axes of a device mesh, on torch.distributed
(the port's counterpart of the ``jax.lax`` collectives the reference
calls inside ``shard_map`` and of those XLA inserts for its GSPMD step).

The execution model is one process a rank. A ``shard_map`` body of the
reference is what every rank runs on its own block; ``lax.psum`` /
``pmax`` / ``pmean`` / ``psum_scatter`` / ``all_gather(tiled=True)`` /
``ppermute`` / ``axis_index`` over a mesh axis (or a tuple of axes)
become a collective on that axis's process group. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose ranks are laid out
row-major over its axes (``init_device_mesh``'s layout), so the ranks
of a group, in rank order, hold the blocks of a dimension sharded over
its axes in block order (the reference's major-to-minor order of a
tuple of axes).

Each differentiable collective is a ``torch.autograd.Function`` whose
backward is its transpose:

* ``psum`` (sum forward, identity backward) and ``copy_to`` (identity
  forward, sum backward): Megatron's g and f around a tensor-parallel
  region, for values replicated over the axis outside it;
* ``all_gather`` <-> ``psum_scatter`` (reduce-scatter): the gradient of
  a gathered value that each rank then used on its own data (another
  batch block) is summed and scattered back; ``all_gather(...,
  replicated=True)`` and ``scatter`` are the pair for a value every
  rank of the axis uses identically (its gradient is the same on each
  rank, so the backward takes, or gathers, the rank's block);
* ``ppermute`` <-> the inverse permutation;
* ``gather_param``: a parameter block gathered at use (FSDP), whose
  gradient comes back as the block's, summed over the data axes;
* ``pmax`` has no transpose (the reference's neither) and takes no
  gradient.

A spec entry may be a ``Halves`` axis (Mamba's ``in_proj``, whose
columns are ``[x | z]``): a rank's block of that dimension is its block
of each half, side by side, so it holds the x and z columns of the same
channels; ``block_of`` cuts it and ``all_gather_`` puts the halves back
in order.

``COLLECTIVE_COUNTS[(op, axis)]`` counts ``[calls, bytes]`` of every
collective a rank launches (bytes: the tensor the rank hands to it), as
each kernel wrapper counts ``LAUNCHES``; ``COLLECTIVE_LOG`` keeps one
``(op, axis, result bytes, group size)`` record a call, what
``launch.hlo_analysis.collective_stats`` turns into the reference's
per-op HLO statistics. A gloo group cannot run most
collectives on CUDA tensors; there the collective's tensor is staged
through host memory and back (transport ``HOST_STAGED_TRANSPORT``,
counted per op in ``HOST_STAGED``): only the collective's bytes leave
the card, and an NCCL group never takes it.

While ``FAKE`` is set (torch's fake process group is the default
group: the dry run's rank 0 of a production mesh,
``launch.mesh.fake_world``) nothing is sent: every collective is
counted and its result is zeros of the result's shape. Never unwritten
memory, so no garbage reaches a router or a kernel; the same values on
every device (the dry run reads shapes and counts, not values).
"""
from __future__ import annotations

import math
from collections.abc import Mapping

import torch
import torch.distributed as tdist

#: (op, axis) -> [calls, bytes] launched by this rank
COLLECTIVE_COUNTS: dict = {}
#: (op, axis, result bytes, group size) of each call, in call order
COLLECTIVE_LOG: list = []
#: set while the default group is torch's fake one (``launch.mesh
#: .fake_world``)
FAKE = False
#: op -> calls staged through host memory (gloo with CUDA tensors)
HOST_STAGED: dict = {}
HOST_STAGED_TRANSPORT = "_gloo_host_staged"

_all_gather_single = getattr(tdist, "all_gather_single", None) or \
    tdist.all_gather_into_tensor
_reduce_scatter_single = getattr(tdist, "reduce_scatter_single", None) or \
    tdist.reduce_scatter_tensor


def reset_counts() -> None:
    COLLECTIVE_COUNTS.clear()
    COLLECTIVE_LOG.clear()
    HOST_STAGED.clear()


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, or of a shape-only mesh
    (an object whose ``.shape`` maps axis names to sizes, as the
    reference's tests' ``FakeMesh``); {} for None."""
    if mesh is None:
        return {}
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def as_axes(axes) -> tuple:
    """An axis name, a tuple of names or None -> a tuple of names."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def spec_entry(axes):
    """A spec's entry in the reference's normal form: None for no axis,
    the name for one, the tuple for several (``PartitionSpec`` keeps a
    1-tuple as its name)."""
    axes = as_axes(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


class Halves(str):
    """A spec entry naming one mesh axis for a dimension of two halves
    side by side (Mamba's ``in_proj`` columns ``[x | z]``): each half is
    cut into blocks over the axis and a rank's block is its block of
    each half, side by side. It equals the axis name, so a spec with it
    compares equal to the reference's ``PartitionSpec``: only the
    port's block of the dimension differs, a whole tensor is the
    same."""

    __slots__ = ()


def _halves(axes) -> bool:
    return any(isinstance(a, Halves) for a in as_axes(axes))


def _unhalve(t, dim, n):
    """Blocks [x_0 z_0 | x_1 z_1 | ...] of ``n`` ranks along ``dim`` ->
    [x_0 x_1 ... | z_0 z_1 ...]."""
    shape = list(t.shape)
    blk = shape[dim] // (2 * n)
    t = t.reshape(shape[:dim] + [n, 2, blk] + shape[dim + 1:])
    return t.transpose(dim, dim + 1).reshape(shape)


def axes_size(dist, axes) -> int:
    sizes = axis_sizes(dist.mesh)
    return math.prod(sizes[a] for a in as_axes(axes))


def axis_index(dist, axes) -> int:
    """This rank's coordinate along ``axes`` (mixed radix, the first
    axis the most significant: the block it holds of a dimension
    sharded over them)."""
    sizes = axis_sizes(dist.mesh)
    idx = 0
    for a in as_axes(axes):
        idx = idx * sizes[a] + dist.mesh.get_local_rank(a)
    return idx


_GROUPS: dict = {}


def group(dist, axes):
    """The process group of this rank over ``axes``. One axis is the
    mesh's own group; a tuple of axes (('pod', 'data'), every axis) is
    made once a mesh with ``new_group`` -- a collective call, so every
    rank asks for the same tuples in the same order (``launch.mesh``
    makes them all when it builds a mesh)."""
    axes = as_axes(axes)
    mesh = dist.mesh
    key = (id(mesh), axes)
    if key in _GROUPS:
        return _GROUPS[key][0]
    if len(axes) == 1:
        g = mesh.get_group(axes[0])
    else:
        names = list(mesh.mesh_dim_names)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{tuple(names)}")
        rest = [i for i in range(len(names)) if i not in pos]
        grid = mesh.mesh.permute(*rest, *pos).reshape(
            -1, math.prod(mesh.mesh.shape[i] for i in pos))
        me = tdist.get_rank()
        g = None
        for row in grid.tolist():
            made = tdist.new_group(row)
            if me in row:
                g = made
    _GROUPS[key] = (g, mesh)             # the mesh kept alive with its id
    return g


def forget_groups() -> None:
    """Drop the multi-axis groups made so far (their world is gone)."""
    _GROUPS.clear()


def make_groups(dist) -> None:
    """Make the multi-axis groups this mesh's collectives use (the data
    axes together when there are several, and every axis)."""
    if len(as_axes(dist.data_axes)) > 1:
        group(dist, dist.data_axes)
    group(dist, tuple(dist.mesh.mesh_dim_names))


def _count(op, axes, t, n, shape):
    """Counts one call of ``op`` over ``axes`` (``n`` ranks) handed
    ``t``, its result of ``shape`` in ``t``'s dtype. Returns that result
    as zeros under ``FAKE``, else None."""
    key = (op, "+".join(as_axes(axes)))
    c = COLLECTIVE_COUNTS.setdefault(key, [0, 0])
    c[0] += 1
    c[1] += t.numel() * t.element_size()
    COLLECTIVE_LOG.append((op, key[1], math.prod(shape) * t.element_size(),
                           n))
    return t.new_zeros(shape) if FAKE else None


def _resized(t, dim, n) -> list:
    """``t``'s shape with dimension ``dim`` of size ``n``."""
    shape = list(t.shape)
    shape[dim] = n
    return shape


def _staged(g, t) -> bool:
    return t.is_cuda and tdist.get_backend(g) == "gloo"


def _host(op, g, t):
    """``t`` where the group's collective can take it: a CUDA tensor of
    a gloo group copied into pinned host memory."""
    if _staged(g, t):
        HOST_STAGED[op] = HOST_STAGED.get(op, 0) + 1
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True) \
            .copy_(t)
    return t


def all_reduce_(dist, axes, t, op=tdist.ReduceOp.SUM):
    """Reduce ``t`` over ``axes``; returns the result (a new tensor
    when staged or under ``FAKE``, else ``t`` reduced in place)."""
    g = group(dist, axes)
    name = "psum" if op == tdist.ReduceOp.SUM else "pmax"
    fake = _count(name, axes, t, axes_size(dist, axes), t.shape)
    if fake is not None:
        return fake
    h = _host(name, g, t.contiguous())
    tdist.all_reduce(h, op=op, group=g)
    return h.to(t.device) if h.device != t.device else h


def all_gather_(dist, axes, t, dim):
    """Every rank's ``t`` concatenated along ``dim`` in block order (no
    gradient)."""
    g = group(dist, axes)
    n = axes_size(dist, axes)
    fake = _count("all_gather", axes, t, n,
                  _resized(t, dim, n * t.shape[dim]))
    if fake is not None:
        return fake
    src = _host("all_gather", g, t.movedim(dim, 0).contiguous())
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device,
                      pin_memory=src.is_pinned())
    _all_gather_single(out, src, group=g)
    out = out.to(t.device).movedim(0, dim)
    if _halves(axes):
        out = _unhalve(out, dim, n)
    return out.contiguous()


def reduce_scatter_(dist, axes, t, dim):
    """Sum ``t`` over ``axes`` and keep this rank's block of ``dim`` (no
    gradient)."""
    g = group(dist, axes)
    n = axes_size(dist, axes)
    if t.shape[dim] % n:
        raise ValueError(f"psum_scatter: dimension {dim} of {tuple(t.shape)}"
                         f" does not divide over {n} ranks of {axes}")
    fake = _count("psum_scatter", axes, t, n,
                  _resized(t, dim, t.shape[dim] // n))
    if fake is not None:
        return fake
    src = _host("psum_scatter", g, t.movedim(dim, 0).contiguous())
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device,
                      pin_memory=src.is_pinned())
    _reduce_scatter_single(out, src, group=g)
    return out.to(t.device).movedim(0, dim).contiguous()


def block_of(dist, axes, t, dim):
    """This rank's block of dimension ``dim`` of ``t`` over ``axes`` (a
    view; a ``Halves`` axis: its block of each half, concatenated)."""
    n = axes_size(dist, axes)
    i = axis_index(dist, axes)
    if _halves(axes):
        size = t.shape[dim] // (2 * n)
        half = t.shape[dim] // 2
        return torch.cat([t.narrow(dim, i * size, size),
                          t.narrow(dim, half + i * size, size)], dim)
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)



class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, axes):
        return all_reduce_(dist, axes, x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, axes):
        ctx.dist, ctx.axes = dist, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(ctx.dist, ctx.axes, g.clone()), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, axes, dim, replicated):
        ctx.args = (dist, axes, dim, replicated)
        return all_gather_(dist, axes, x, dim)

    @staticmethod
    def backward(ctx, g):
        dist, axes, dim, replicated = ctx.args
        if replicated:
            return block_of(dist, axes, g, dim).contiguous(), None, None, \
                None, None
        return reduce_scatter_(dist, axes, g, dim), None, None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, axes, dim):
        ctx.args = (dist, axes, dim)
        return reduce_scatter_(dist, axes, x, dim)

    @staticmethod
    def backward(ctx, g):
        dist, axes, dim = ctx.args
        return all_gather_(dist, axes, g, dim), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, axes, dim):
        ctx.args = (dist, axes, dim)
        return block_of(dist, axes, x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        dist, axes, dim = ctx.args
        return all_gather_(dist, axes, g, dim), None, None, None


def psum(x, dist, axes):
    """Sum over ``axes`` (Megatron's g: the gradient passes unchanged)."""
    return _Psum.apply(x, dist, as_axes(axes))


def pmean(x, dist, axes):
    return psum(x, dist, axes) / axes_size(dist, axes)


def copy_to(x, dist, axes):
    """The identity (Megatron's f: the gradient is summed over ``axes``)."""
    return _CopyTo.apply(x, dist, as_axes(axes))


def pmax(x, dist, axes):
    """Max over ``axes``; not differentiable (as the reference's)."""
    if x.requires_grad:
        raise ValueError("pmax takes no gradient")
    return all_reduce_(dist, axes, x.clone(), tdist.ReduceOp.MAX)


def all_gather(x, dist, axes, dim, replicated=False):
    """Concatenate every rank's ``x`` along ``dim`` in block order
    (``lax.all_gather(tiled=True)``); the backward reduce-scatters, or
    with ``replicated`` takes this rank's block."""
    return _AllGather.apply(x, dist, as_axes(axes), dim, replicated)


def psum_scatter(x, dist, axes, dim):
    """Sum over ``axes`` and keep this rank's block of ``dim``
    (``lax.psum_scatter(tiled=True)``); the backward all-gathers."""
    return _PsumScatter.apply(x, dist, as_axes(axes), dim)


def scatter(x, dist, axes, dim):
    """This rank's block of ``dim`` of a value replicated over ``axes``;
    the backward all-gathers."""
    return _Scatter.apply(x, dist, as_axes(axes), dim)


def _permute(dist, axis, t, perm):
    g = group(dist, axis)
    me = axis_index(dist, axis)
    fake = _count("ppermute", axis, t, axes_size(dist, axis), t.shape)
    if fake is not None:
        return fake
    src = _host("ppermute", g, t.contiguous())
    out = torch.zeros_like(src)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(src)
        elif s == me:
            ops.append(tdist.P2POp(tdist.isend, src,
                                   tdist.get_global_rank(g, d), g))
        elif d == me:
            ops.append(tdist.P2POp(tdist.irecv, out,
                                   tdist.get_global_rank(g, s), g))
    if ops:
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
    return out.to(t.device)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, axis, perm):
        ctx.args = (dist, axis, perm)
        return _permute(dist, axis, x, perm)

    @staticmethod
    def backward(ctx, g):
        dist, axis, perm = ctx.args
        inverse = tuple((d, s) for s, d in perm)
        return _permute(dist, axis, g, inverse), None, None, None


def ppermute(x, dist, axis, perm):
    """``lax.ppermute``: rank ``s`` of ``axis`` sends ``x`` to ``d`` for
    each (s, d) of ``perm``; a rank nobody sends to gets zeros."""
    return _Ppermute.apply(x, dist, axis, tuple(map(tuple, perm)))


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, spec, keep, partial):
        ctx.args = (dist, spec, keep, partial)
        for dim, ent in enumerate(spec):
            axes = as_axes(ent)
            if axes and not set(axes) <= keep:
                x = all_gather_(dist, axes, x, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        dist, spec, keep, partial = ctx.args
        data = as_axes(dist.data_axes)
        g = g.contiguous()
        if partial:
            g = all_reduce_(dist, tuple(partial), g.clone())
        used = set()
        for dim, ent in enumerate(spec):
            axes = as_axes(ent)
            used |= set(axes)
            if not axes or set(axes) <= keep:
                continue
            if set(axes) <= set(data):
                g = reduce_scatter_(dist, axes, g, dim)
            else:
                g = block_of(dist, axes, g, dim).contiguous()
        rest = tuple(a for a in data if a not in used)
        if rest:
            g = all_reduce_(dist, rest, g.clone())
        return g, None, None, None, None


def gather_param(x, dist, spec, keep=(), partial=()):
    """A parameter block ``x`` laid out by ``spec`` (one entry a
    dimension: None, an axis or a tuple of axes) -> the tensor the layer
    uses: gathered over every axis but those in ``keep`` (a
    tensor-parallel layer keeps its ``model`` block). The backward
    returns the block's gradient, reduced as the single-device gradient
    is distributed: summed over ``partial`` axes first (the layer's use
    on each rank covers only its part of the model, e.g. the kv heads a
    rank's q heads read), then reduce-scattered over the data axes it
    was gathered over, cut to the block on the other gathered axes
    (every rank of those used it alike) and summed over the data axes it
    is replicated over (each rank saw another block of the batch)."""
    return _GatherParam.apply(x, dist, tuple(spec), frozenset(as_axes(keep)),
                              tuple(as_axes(partial)))
