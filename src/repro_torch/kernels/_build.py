"""Build the port's CUDA sources with ``nvcc``, load them with ctypes,
and the checks and launch shared by the kernels' wrappers.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain
C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC <SOURCE_FLAGS[name]>
         -o build/repro_torch/<name>-<hash>.so

into ``build/repro_torch/`` at the repository root (listed in
.gitignore), with nvcc's output beside it in ``<name>-<hash>.log``.
``<hash>`` covers the source and every flag, the source's own included,
so an edited source or flag rebuilds and an unchanged one is reused.
``-fmad=false`` keeps every product rounded before it is added, as the
plain PyTorch versions round it. ``SOURCE_FLAGS`` adds flags to one
source: each asks ptxas for its report (``-Xptxas -v``: registers,
spills and shared memory of every kernel), which ``build_log`` reads
back. Nothing here runs at import: the first ``load`` builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
#: extra nvcc flags of one source (after NVCC_FLAGS)
SOURCE_FLAGS = {
    "flash_attention": ("-Xptxas", "-v"),
    "lcdc_switch": ("-Xptxas", "-v"),
    "rwkv6_wkv": ("-Xptxas", "-v"),
}

_LOADED: dict[str, ctypes.CDLL] = {}
_FUNCTIONS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc
    or ``nvcc`` on PATH; raises if there is none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on first use and need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def flags(name: str) -> tuple[str, ...]:
    """Every nvcc flag of ``csrc/<name>.cu``."""
    return NVCC_FLAGS + tuple(SOURCE_FLAGS.get(name, ()))


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + b"\0" + "\0".join(flags(name)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output from the build of ``csrc/<name>.cu``'s current
    library ("" before it is built)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def build(names=None) -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` (or just ``names``) whose library is
    missing, one ``nvcc`` per source, all started together. Returns
    {name: library path}; raises with nvcc's output if one fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs, out = {}, {}
    for name in names:
        target = _target(name)
        out[name] = target
        if target.is_file():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            out[name].with_suffix(".log").write_text(log)
            os.replace(tmp, out[name])     # atomic: readers never see half
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed (once per process)."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LOADED[name] = lib
    return lib


def function(name: str, symbol: str, argtypes):
    """The C entry ``symbol`` of ``csrc/<name>.cu``, typed with
    ``argtypes`` and returning the launch's cudaError_t as an int."""
    fn = _FUNCTIONS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCTIONS[(name, symbol)] = fn
    return fn


def check(kernel, name, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and
    ``shape`` on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{kernel}: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def launch(kernel, fn, device, *args):
    """Call the C entry ``fn`` with ``args`` and the current CUDA stream
    of ``device``; raise if it returns a cudaError_t other than 0."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t "
                           f"{err}")
