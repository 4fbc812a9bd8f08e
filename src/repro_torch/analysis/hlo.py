"""The port's artifact vocabulary: what the audit reads off one tick.

The reference compiles its chunk program and reads XLA's artifact
(the optimized HLO text, ``cost_analysis()``, ``memory_analysis()``,
the input-output alias table). The port's artifact is one tick, run
under a counter and, on the card, captured as a CUDA graph:

* :class:`TickCounter` - ``launch.hlo_analysis.CostCounter`` (FLOPs and
  bytes op by op under XLA's rules; the switch datapath one operator on
  every device) that also keeps the op inventory RL008 reads: every op
  name, the ops that copy between devices, and the collectives;
* :func:`graph_nodes` - the node kinds of a captured ``cudaGraph_t``
  (``CUDAGraph(keep_graph=True).raw_cuda_graph()``), read through
  libcuda, with the direction of every copy node: a host node or a
  device-to-host copy is a host round trip inside the replayed tick;
* :func:`peak_bytes` - the most device memory a call holds live at
  once beyond what it started with: a tick's peak working set on the
  card (RL007's budget); :func:`pool_bytes` - what a captured graph's
  private pool reserves.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.launch.hlo_analysis import CostCounter

#: op namespaces of collectives (a tick moves nothing between ranks)
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")
#: ops that copy a device value to the host and wait for it
HOST_READ_OPS = ("_local_scalar_dense", "item")


def _devices(x, out: set) -> set:
    """Devices of the tensors in ``x``; a 0-d CPU tensor is a scalar
    the host holds (an op reads it as a number), not a device value."""
    if isinstance(x, torch.Tensor):
        if not (x.device.type == "cpu" and x.dim() == 0):
            out.add(str(x.device))
    elif isinstance(x, (list, tuple)):
        for y in x:
            _devices(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _devices(y, out)
    return out


class TickCounter(CostCounter):
    """``CostCounter`` plus the op inventory of what ran under it."""

    def __init__(self):
        super().__init__()
        self.ops: collections.Counter = collections.Counter()
        self.crossings: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        name = f"{func.namespace}.{func.overloadpacket.__name__}"
        self.ops[name] += 1
        if func.overloadpacket.__name__.rstrip("_") in ("copy",
                                                         "_copy_from"):
            src, dst = _devices(args[1], set()), _devices(args[0], set())
        else:
            src = _devices(list(args) + list(kwargs.values()), set())
            dst = _devices(out, set())
        if src and dst - src:
            self.crossings[f"{name}: {sorted(src)} -> "
                           f"{sorted(dst - src)}"] += 1
        return out

    def collectives(self) -> dict:
        return {k: n for k, n in self.ops.items()
                if k.split(".")[0] in COLLECTIVE_NAMESPACES}

    def host_reads(self) -> dict:
        return {k: n for k, n in self.ops.items()
                if k.split(".")[-1].rstrip("_") in HOST_READ_OPS}


# ---------------------------------------------------------------------------
# a captured CUDA graph, through libcuda
# ---------------------------------------------------------------------------

#: CUgraphNodeType -> name
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
              4: "graph", 5: "empty", 6: "wait_event", 7: "event_record",
              8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
              11: "mem_free", 12: "batch_mem_op", 13: "conditional"}
#: CUmemorytype -> name (4: unified, resolved through the pointer)
_MEMORY = {1: "host", 2: "device", 3: "array"}
_CU_POINTER_ATTRIBUTE_MEMORY_TYPE = 2


class _Memcpy3D(ctypes.Structure):
    """CUDA_MEMCPY3D (cuda.h)."""
    _fields_ = [(f"{side}{name}", kind) for side in ("src", "dst")
                for name, kind in (
                    ("XInBytes", ctypes.c_size_t), ("Y", ctypes.c_size_t),
                    ("Z", ctypes.c_size_t), ("LOD", ctypes.c_size_t),
                    ("MemoryType", ctypes.c_int), ("Host", ctypes.c_void_p),
                    ("Device", ctypes.c_uint64), ("Array", ctypes.c_void_p),
                    ("Reserved", ctypes.c_void_p), ("Pitch", ctypes.c_size_t),
                    ("Height", ctypes.c_size_t))] + [
        ("WidthInBytes", ctypes.c_size_t), ("Height", ctypes.c_size_t),
        ("Depth", ctypes.c_size_t)]


def _libcuda():
    cu = ctypes.CDLL("libcuda.so.1")
    for fn in ("cuGraphGetNodes", "cuGraphNodeGetType",
               "cuGraphMemcpyNodeGetParams", "cuGraphChildGraphNodeGetGraph",
               "cuPointerGetAttribute"):
        getattr(cu, fn).restype = ctypes.c_int
    return cu


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUresult {err}")


def _memory(cu, kind: int, host, device) -> str:
    if kind in _MEMORY:
        return _MEMORY[kind]
    ptr = device or host or 0
    mtype = ctypes.c_uint(0)
    err = cu.cuPointerGetAttribute(ctypes.byref(mtype),
                                   _CU_POINTER_ATTRIBUTE_MEMORY_TYPE,
                                   ctypes.c_uint64(ptr))
    # pageable host memory is no allocation libcuda knows
    return _MEMORY.get(mtype.value, "host") if err == 0 else "host"


def graph_nodes(raw_graph: int) -> dict:
    """``{"kinds": {kind: n}, "copies": {"device->host": n, ...}}`` of
    a ``cudaGraph_t``, child graphs included."""
    cu = _libcuda()
    kinds: collections.Counter = collections.Counter()
    copies: collections.Counter = collections.Counter()

    def walk(graph):
        n = ctypes.c_size_t(0)
        _check(cu.cuGraphGetNodes(ctypes.c_void_p(graph), None,
                                  ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        _check(cu.cuGraphGetNodes(ctypes.c_void_p(graph), nodes,
                                  ctypes.byref(n)), "cuGraphGetNodes")
        for node in nodes:
            t = ctypes.c_int(-1)
            _check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                         ctypes.byref(t)),
                   "cuGraphNodeGetType")
            kind = NODE_KINDS.get(t.value, f"type{t.value}")
            kinds[kind] += 1
            if kind == "memcpy":
                p = _Memcpy3D()
                _check(cu.cuGraphMemcpyNodeGetParams(ctypes.c_void_p(node),
                                                     ctypes.byref(p)),
                       "cuGraphMemcpyNodeGetParams")
                src = _memory(cu, p.srcMemoryType, p.srcHost, p.srcDevice)
                dst = _memory(cu, p.dstMemoryType, p.dstHost, p.dstDevice)
                copies[f"{src}->{dst}"] += 1
            elif kind == "graph":
                child = ctypes.c_void_p()
                _check(cu.cuGraphChildGraphNodeGetGraph(
                    ctypes.c_void_p(node), ctypes.byref(child)),
                    "cuGraphChildGraphNodeGetGraph")
                walk(child.value)

    walk(raw_graph)
    return {"kinds": dict(kinds), "copies": dict(copies)}


def peak_bytes(fn, dev) -> int:
    """The most device memory ``fn()`` holds live at once on ``dev``
    beyond what was allocated before it (the caching allocator's count,
    in its 512 B blocks): for a tick, its intermediates at their peak.
    Resets the device's peak-memory statistics."""
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) - before


def pool_bytes(graph) -> int:
    """Bytes of the device memory a captured ``CUDAGraph``'s private
    pool reserves (its segments; the caching allocator reserves them
    2 MiB at a time)."""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)
