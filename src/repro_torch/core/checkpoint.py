"""Durable sweep execution: chunk-boundary checkpoint files.

Counterpart of ``repro/core/checkpoint.py``, the same file format, so a
checkpoint written by either engine is read by the other. This module is
the storage half of the durability contract; the simulator half (what
goes *into* a snapshot and how a run restarts from one) lives in
``core/simulator.py`` (``_snapshot_sweep`` / ``resume_sweep``).

A checkpoint is one self-contained ``.ckpt.npz`` file holding

* a JSON metadata record (the ``__meta__`` member): schema versions
  (``ckpt_schema`` = :data:`CKPT_SCHEMA_VERSION`, ``sim_schema`` =
  ``simulator.SIM_SCHEMA_VERSION``), the fault/flow knob fingerprints,
  the fold dtype (``"float32"``: the port folds in float32 Kahan
  pairs), the scenario field inventory, the run geometry (n_ticks /
  effective chunk length / chunk index), the full scenario-batch recipe
  (hull + per-scenario sites, names, labels, gating flags, seeds), the
  validate/tol mode, the threefry counter scheme, and, for planned
  sweeps, the plan fingerprint + bucket identity;
* the raw per-scenario carry arrays: every ``SimState`` leaf, the Kahan
  fold ``(sum, comp)`` buffers, the validation guard, and every
  ``Scenario`` leaf.

Invariants enforced here:

* **Atomicity**: files are written to a temp name in the destination
  directory, fsynced, then ``os.replace``d into place, so a crash
  mid-write never leaves a truncated checkpoint under the final name
  (:func:`atomic_write_bytes`; :func:`atomic_write_text` is the same
  primitive for JSON writers).
* **Integrity**: a sha256 content checksum over the metadata and
  every array (name, dtype, shape, bytes) is embedded in the metadata
  and re-verified on read; corruption fails fast as a structured
  :class:`CheckpointError` instead of resuming from garbage.
* **Fail-fast mismatch**: every reader raises :class:`CheckpointError`
  with a machine-readable ``reason`` naming the first mismatch
  ("checksum", "ckpt_schema", "sim_schema", "x64_mode", ...) rather
  than a generic exception.

This module knows nothing about tensors: it moves named numpy arrays
and JSON, so ``simulator`` imports it, never the reverse.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import re
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np

#: bump when the on-disk layout changes; resume fails fast on mismatch
#: instead of misinterpreting an old file
CKPT_SCHEMA_VERSION = 1

#: default checkpoint directory (repo-root ``results/checkpoints/``;
#: results/ is gitignored, so checkpoints never land in the tree)
DEFAULT_DIR = Path(__file__).resolve().parents[3] / "results" / "checkpoints"

#: npz member carrying the JSON metadata record
_META_MEMBER = "__meta__"

_SUFFIX = ".ckpt.npz"
_FILE_RE = re.compile(r"^(?P<tag>.+)-(?P<chunk>\d{8})\.ckpt\.npz$")
_TAG_RE = re.compile(r"^[A-Za-z0-9._-]+$")


class CheckpointError(RuntimeError):
    """A checkpoint could not be read or does not match this engine.

    ``reason`` is a stable machine-readable mismatch class — one of
    ``"format"`` (unreadable/truncated file), ``"checksum"`` (content
    checksum mismatch), ``"ckpt_schema"``, ``"sim_schema"``,
    ``"x64_mode"``, ``"fingerprint"`` (fault/flow knob inventory),
    ``"scenario_fields"``, or ``"state_schema"`` (missing/extra/shaped-
    differently carry arrays). ``detail`` is the human-readable
    elaboration naming the exact mismatch.
    """

    def __init__(self, reason: str, detail: str):
        self.reason = reason
        self.detail = detail
        super().__init__(f"checkpoint rejected ({reason}): {detail}")


@dataclass(frozen=True)
class CheckpointSpec:
    """Where and how often a sweep snapshots its carry.

    ``every_chunks`` is a cadence over the sweep's chunk boundaries: a
    snapshot of the full per-scenario carry is taken whenever the
    completed-chunk count is a multiple of it (the final boundary is
    excluded — the run is finished there, not resumable). ``keep``
    bounds the files retained per tag; older cadence snapshots are
    pruned after each successful write. The snapshot fetch is the
    registered blessed host-transfer point, so with a cadence of ``c``
    a run's ``HOST_TRANSFER_COUNT`` is exactly ``1 + n_checkpoints``.
    """

    directory: str | Path = DEFAULT_DIR
    every_chunks: int = 1
    tag: str = "sweep"
    keep: int = 2

    def __post_init__(self):
        def bad(msg: str):
            raise ValueError(f"CheckpointSpec: {msg}")

        if not (isinstance(self.every_chunks, int)
                and self.every_chunks >= 1):
            bad(f"every_chunks must be an int >= 1, got "
                f"{self.every_chunks!r}")
        if not (isinstance(self.keep, int) and self.keep >= 1):
            bad(f"keep must be an int >= 1, got {self.keep!r}")
        if not _TAG_RE.match(str(self.tag)):
            bad(f"tag must match {_TAG_RE.pattern}, got {self.tag!r}")

    def path_for(self, chunk_index: int) -> Path:
        """Checkpoint filename for a snapshot taken at ``chunk_index``
        completed chunks."""
        return Path(self.directory) / f"{self.tag}-{chunk_index:08d}{_SUFFIX}"


def atomic_write_bytes(path: str | Path, data: bytes) -> Path:
    """Write ``data`` to ``path`` via temp-file + fsync + ``os.replace``
    so readers never observe a partial file and an interrupted write
    never clobbers the previous version."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=path.name + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def atomic_write_text(path: str | Path, text: str) -> Path:
    """Atomic (temp + rename) replacement for ``Path.write_text``."""
    return atomic_write_bytes(path, text.encode("utf-8"))


def _checksum(meta: dict, arrays: dict) -> str:
    """sha256 over the metadata record and every array's identity and
    contents (name, dtype, shape, raw bytes) in sorted-name order."""
    h = hashlib.sha256()
    h.update(json.dumps(meta, sort_keys=True).encode("utf-8"))
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode("utf-8"))
        h.update(str(a.dtype).encode("utf-8"))
        h.update(str(a.shape).encode("utf-8"))
        h.update(a.tobytes())
    return h.hexdigest()


def write_checkpoint(path: str | Path, meta: dict, arrays: dict) -> Path:
    """Atomically write one checkpoint file.

    ``meta`` must be JSON-serializable; ``ckpt_schema`` and the content
    ``checksum`` are stamped here (any caller-provided values are
    overwritten), so every file this function produces is verifiable by
    :func:`read_checkpoint`.
    """
    meta = dict(meta)
    meta.pop("checksum", None)
    meta["ckpt_schema"] = CKPT_SCHEMA_VERSION
    meta["checksum"] = _checksum(
        {k: v for k, v in meta.items() if k != "checksum"}, arrays)
    blob = io.BytesIO()
    np.savez(blob, **{
        _META_MEMBER: np.frombuffer(
            json.dumps(meta, sort_keys=True).encode("utf-8"),
            dtype=np.uint8)}, **arrays)
    return atomic_write_bytes(path, blob.getvalue())


def read_checkpoint(path: str | Path) -> tuple[dict, dict]:
    """Load and verify one checkpoint file -> ``(meta, arrays)``.

    Raises :class:`CheckpointError` with reason ``"format"`` when the
    file is unreadable (truncated zip, missing metadata member, broken
    JSON), ``"ckpt_schema"`` when written by an incompatible layout
    version, or ``"checksum"`` when the content hash does not match.
    """
    path = Path(path)
    try:
        with np.load(path, allow_pickle=False) as z:
            names = list(z.files)
            if _META_MEMBER not in names:
                raise CheckpointError(
                    "format", f"{path}: missing {_META_MEMBER} member")
            meta_raw = bytes(z[_META_MEMBER].tobytes())
            arrays = {n: z[n] for n in names if n != _META_MEMBER}
    except CheckpointError:
        raise
    except Exception as exc:
        raise CheckpointError(
            "format",
            f"{path}: unreadable ({type(exc).__name__}: {exc})") from exc
    try:
        meta = json.loads(meta_raw.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as exc:
        raise CheckpointError(
            "format", f"{path}: metadata is not valid JSON") from exc
    if not isinstance(meta, dict):
        raise CheckpointError(
            "format", f"{path}: metadata is not a JSON object")
    if meta.get("ckpt_schema") != CKPT_SCHEMA_VERSION:
        raise CheckpointError(
            "ckpt_schema",
            f"{path}: written with checkpoint schema "
            f"{meta.get('ckpt_schema')!r}, this engine reads "
            f"{CKPT_SCHEMA_VERSION}")
    want = meta.get("checksum")
    got = _checksum({k: v for k, v in meta.items() if k != "checksum"},
                    arrays)
    if want != got:
        raise CheckpointError(
            "checksum",
            f"{path}: stored {str(want)[:12]}..., recomputed "
            f"{got[:12]}... — file corrupt or tampered")
    return meta, arrays


def list_checkpoints(directory: str | Path,
                     tag: str | None = None) -> list[tuple[int, Path]]:
    """All checkpoint files in ``directory`` (optionally for one tag),
    as ``(chunk_index, path)`` sorted by ascending chunk index."""
    directory = Path(directory)
    if not directory.is_dir():
        return []
    out = []
    for p in directory.iterdir():
        m = _FILE_RE.match(p.name)
        if m is None:
            continue
        if tag is not None and m.group("tag") != tag:
            continue
        out.append((int(m.group("chunk")), p))
    return sorted(out)


def latest_checkpoint(directory: str | Path,
                      tag: str | None = None) -> Path | None:
    """Path of the highest-chunk-index checkpoint, or None."""
    found = list_checkpoints(directory, tag)
    return found[-1][1] if found else None


def prune(spec: CheckpointSpec) -> None:
    """Drop all but the newest ``spec.keep`` checkpoints of this tag.
    Best-effort: a concurrent unlink is not an error."""
    found = list_checkpoints(spec.directory, spec.tag)
    for _, p in found[:-spec.keep]:
        try:
            p.unlink()
        except OSError:
            pass
