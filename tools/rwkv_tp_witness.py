"""Is RWKV's tensor-parallel gradient the one-device gradient?

Computes the gradient of one training loss of rwkv6-7b (full width, 2
layers, B 2 x T 512, random weights from seed 0) on one device and on
(data, model) meshes of 4 gloo ranks with RWKV tensor-parallel over
'model', and prints each leaf's distance between them as a share of the
leaf's largest magnitude:

- float64 through the plain versions, with the model's float32 casts
  (the norms, the decay, the plain wkv scan, the logits) lifted so that
  float64 stays float64: the witness of the algebra, which sharding
  leaves exact up to float64 rounding;
- float32 through the plain versions and (on a GPU) through the wkv
  kernels, each against the float64 gradient and against its
  one-device counterpart;
- on the (2, 2) mesh, the float32 kernel path against one device at the
  shorter lengths SHORT.

Run from the repository root: ``python3 tools/rwkv_tp_witness.py`` on a
machine with one CUDA device (the 4 ranks share it; ~7 minutes on an
H100), or ``python3 tools/rwkv_tp_witness.py --cpu --reduced`` for the
reduced config on the CPU (plain versions only, ~1 minute). Files go to
``build/rwkv_tp_witness`` and are removed at the end.
"""
import dataclasses
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "rwkv_tp_witness"
SEQ = 512
SHORT = (64, 128, 256)
MESHES = ((1, 4), (2, 2))
CPU = "--cpu" in sys.argv
REDUCED = "--reduced" in sys.argv


def _setup():
    import torch
    # a float64 run stays float64 through the model's float32 casts
    orig = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: (
        self if self.dtype == torch.float64 else orig(self, *a, **k))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if CPU:
        torch.set_num_threads(1)
        return torch, torch.device("cpu")
    torch.cuda.set_device(0)
    return torch, torch.device("cuda:0")


def _cfg(dtype):
    from repro_torch.configs import get_config, reduced
    cfg = get_config("rwkv6-7b")
    return dataclasses.replace(reduced(cfg) if REDUCED else cfg,
                               n_layers=2, dtype=dtype)


def _batch(torch, cfg, T, dev):
    import numpy as np
    rng = np.random.default_rng(0)
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, T)), device=dev)
            for k in ("tokens", "targets")}


def _grads(cfg, params, batch, kernels, dist=None):
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.kernels import ops
    from repro_torch.train.steps import _loss_and_grads
    p = tree_map(lambda t: t.to(cfg.dtype), params)
    fns = ops.model_kernel_fns() if kernels else None
    return [g.detach() for g in
            leaves(_loss_and_grads(cfg, p, batch, fns, dist)[2])]


def _single(_):
    torch, dev = _setup()
    from repro_torch.core.tree import paths
    from repro_torch.models import model as M
    c32 = _cfg(torch.float32)
    c64 = dataclasses.replace(c32, dtype=torch.float64)
    params = M.init_params(c32, 0, device=dev)
    b = _batch(torch, c32, SEQ, dev)
    res = {"names": ["/".join(map(str, k)) for k, _ in paths(params)]}
    g64 = _grads(c64, params, b, False)
    torch.save([g.cpu() for g in g64], OUT / "g64.pt")
    runs = [("plain32", False)] + ([] if CPU else [("kernel32", True)])
    for tag, kernels in runs:
        g = _grads(c32, params, b, kernels)
        torch.save([t.cpu() for t in g], OUT / f"{tag}.pt")
        res[f"one {tag} vs one f64"] = [
            float((a.double() - c).abs().max() / c.abs().max())
            for a, c in zip(g, g64)]
    for T in () if CPU else SHORT:
        g = _grads(c32, params, _batch(torch, c32, T, dev), True)
        torch.save([t.cpu() for t in g], OUT / f"kernel32_T{T}.pt")
    (OUT / "single.json").write_text(json.dumps(res))


def _ranks(rank, shape):
    torch, dev = _setup()
    import torch.distributed as tdist
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import dist_for, make_test_mesh
    from repro_torch.models import model as M
    tdist.init_process_group("gloo", init_method=f"file://{OUT}/store_"
                             f"{shape[0]}x{shape[1]}", rank=rank,
                             world_size=4)
    dist = dist_for(make_test_mesh(*shape))
    c32 = _cfg(torch.float32)
    c64 = dataclasses.replace(c32, dtype=torch.float64)
    specs = shd.spec_leaves(shd.param_specs(c32, dist)[0])
    blocks = M.init_params(c32, 0, device=dev, dist=dist)
    b = _batch(torch, c32, SEQ, dev)

    def dist_of(got, tag):
        """Each leaf's max |block - one device's block| / max |leaf|,
        over the ranks."""
        want = torch.load(OUT / f"{tag}.pt", mmap=True)
        e = torch.tensor([float((a.double().cpu() - shd.block(c, s, dist)
                                 .double()).abs().max()
                                / max(float(c.abs().max()), 1e-300))
                          for a, c, s in zip(got, want, specs)],
                         dtype=torch.float64)
        tdist.all_reduce(e, op=tdist.ReduceOp.MAX)
        return e.tolist()

    res = {"TP f64 vs one f64": dist_of(_grads(c64, blocks, b, False, dist),
                                        "g64")}
    for tag, kernels in [("plain32", False)] + ([] if CPU
                                                else [("kernel32", True)]):
        g = _grads(c32, blocks, b, kernels, dist)
        res[f"TP {tag} vs one f64"] = dist_of(g, "g64")
        res[f"TP {tag} vs one {tag}"] = dist_of(g, tag)
    for T in SHORT if shape == (2, 2) and not CPU else ():
        g = _grads(c32, blocks, _batch(torch, c32, T, dev), True, dist)
        res[f"TP kernel32 vs one kernel32, T {T}"] = dist_of(
            g, f"kernel32_T{T}")
    if rank == 0:
        (OUT / f"mesh_{shape[0]}x{shape[1]}.json").write_text(
            json.dumps(res))
    tdist.barrier()
    tdist.destroy_process_group()


def main():
    import torch.multiprocessing as mp
    if not CPU:
        from repro_torch.kernels import _build
        _build.build()
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    t0 = time.perf_counter()
    mp.spawn(_single, nprocs=1, join=True)
    cols = json.loads((OUT / "single.json").read_text())
    names = cols.pop("names")
    for shape in MESHES:
        mp.spawn(_ranks, args=(shape,), nprocs=4, join=True)
        got = json.loads((OUT / f"mesh_{shape[0]}x{shape[1]}.json")
                         .read_text())
        cols.update({f"{shape} {k}": v for k, v in got.items()})
    print(f"rwkv6-7b{' reduced' if REDUCED else ''}, 2 layers, B 2 x T "
          f"{SEQ}, on {'the CPU' if CPU else 'one GPU'}: each leaf's "
          f"distance, of its scale ({time.perf_counter() - t0:.0f} s)")
    print("leaf | " + " | ".join(cols))
    for i, n in enumerate(names):
        print(n + " | " + " | ".join(f"{v[i]:.3g}" for v in cols.values()))
    for k, v in cols.items():
        print(f"worst {k}: {max(v):.4g} ({names[v.index(max(v))]})")
    shutil.rmtree(OUT, ignore_errors=True)


if __name__ == "__main__":
    main()
