"""Atomic, async checkpoints of training state (counterpart of
``repro/checkpoint/checkpointer.py``), in the reference's layout:

    <dir>/step_<N>/manifest.json   (structure, shapes, dtypes, step)
                   shard_<i>.npz   (leaf arrays, ~512 MB a shard)
    <dir>/.tmp_step_<N>/           (written first, then os.replace'd)

with keep-k retention. A tree is flattened in ``core.tree``'s order
(dicts by sorted key, lists in order: the reference's order for its
trees) and its structure is written as a ``PyTreeDef`` string. numpy
has no bfloat16 (and the card's machine has no ml_dtypes), so a
bfloat16 leaf is stored as its uint16 bits with "bfloat16" in the
manifest's ``dtypes`` and viewed back on restore. ``restore`` with no
``tree_like`` returns the stored tree as numpy arrays in the stored
structure, which also reads a checkpoint the reference wrote (its
float32 trees; ``core.convert`` carries them across).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.tree import (leaves, paths, parse_treedef, treedef,
                                   unflatten)

SHARD_BYTES = 512 * 2 ** 20
#: written in the manifest of the port's checkpoints (the reference's
#: have no "layout")
LAYOUT = "repro_torch"


def _to_host(x):
    """A leaf -> (numpy array, dtype name)."""
    if isinstance(x, torch.Tensor):
        # a copy: the caller's tensors may change once this returns
        x = x.detach().clone() if x.device.type == "cpu" else x.cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = x.numpy()
        return a, str(a.dtype)
    a = np.array(x)
    return a, str(a.dtype)


def snapshot(tree) -> tuple[str, list]:
    """(structure string, [(numpy array, dtype name)]) of ``tree``: the
    host copy ``save`` writes, taken on the calling thread."""
    return treedef(tree), [_to_host(x) for x in leaves(tree)]


def save(path, tree, step: int, keep: int = 3) -> Path:
    """Synchronous atomic save of ``tree``. Returns the final checkpoint
    dir."""
    return _write(path, snapshot(tree), step, keep)


def _write(path, snap, step: int, keep: int) -> Path:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    final = path / f"step_{step:08d}"
    tmp = path / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    struct, host = snap
    shards: list[list[int]] = [[]]
    size = 0
    for i, (a, _) in enumerate(host):
        if size > SHARD_BYTES:
            shards.append([])
            size = 0
        shards[-1].append(i)
        size += a.nbytes
    for si, idxs in enumerate(shards):
        np.savez(tmp / f"shard_{si}.npz",
                 **{f"leaf_{i}": host[i][0] for i in idxs})
    manifest = {
        "step": step,
        "n_leaves": len(host),
        "treedef": struct,
        "shards": {str(si): idxs for si, idxs in enumerate(shards)},
        "shapes": [list(a.shape) for a, _ in host],
        "dtypes": [name for _, name in host],
        "layout": LAYOUT,
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                       # atomic publish
    _retain(path, keep)
    return final


class AsyncCheckpointer:
    """Snapshot on the caller's thread, write on a daemon thread."""

    def __init__(self, path, keep: int = 3):
        self.path = Path(path)
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save_async(self, tree, step: int):
        self.wait()
        # snapshot NOW, so the next step's updates cannot race the write
        snap = snapshot(tree)
        self._thread = threading.Thread(
            target=_write, args=(self.path, snap, step, self.keep),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _retain(path: Path, keep: int):
    ckpts = sorted(p for p in path.iterdir()
                   if p.is_dir() and p.name.startswith("step_"))
    for old in ckpts[:-keep]:
        shutil.rmtree(old)


def latest_step(path) -> int | None:
    path = Path(path)
    if not path.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in path.iterdir()
             if p.is_dir() and p.name.startswith("step_")
             and (p / "manifest.json").exists()]
    return max(steps) if steps else None


def manifest(path, step: int | None = None) -> dict:
    """The manifest of checkpoint ``step`` (the latest if None)."""
    path = Path(path)
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    return json.loads((path / f"step_{step:08d}" / "manifest.json")
                      .read_text())


def _from_host(a, name, like=None):
    a = np.array(a)                      # contiguous, 0-d kept 0-d
    if name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if like is not None:
        t = t.to(like.device)
    return t


def restore(path, tree_like=None, step: int | None = None):
    """(tree, step) of checkpoint ``step`` (the latest if None). With
    ``tree_like`` the leaves come back as tensors in its structure, on
    its leaves' devices (their count, shapes and dtypes must match);
    without, the stored structure with numpy leaves (bfloat16 ones as
    tensors, numpy having no bfloat16)."""
    path = Path(path)
    meta = manifest(path, step)
    step = meta["step"]
    d = path / f"step_{step:08d}"
    host = [None] * meta["n_leaves"]
    for si, idxs in meta["shards"].items():
        with np.load(d / f"shard_{si}.npz") as z:
            for i in idxs:
                host[i] = z[f"leaf_{i}"]
    names = meta["dtypes"]
    if tree_like is None:
        flat = [_from_host(a, n) if n == "bfloat16" else a
                for a, n in zip(host, names)]
        return unflatten(parse_treedef(meta["treedef"]), flat), step
    like = [leaf for _, leaf in paths(tree_like)]
    if len(like) != len(host):
        raise ValueError(f"checkpoint has {len(host)} leaves, target "
                         f"{len(like)}")
    flat = []
    for a, n, t in zip(host, names, like):
        x = _from_host(a, n, t)
        if tuple(x.shape) != tuple(t.shape) or x.dtype != t.dtype:
            raise ValueError(f"checkpoint leaf {tuple(x.shape)} {x.dtype} "
                             f"does not match {tuple(t.shape)} {t.dtype}")
        flat.append(x)
    return unflatten(tree_like, flat), step
