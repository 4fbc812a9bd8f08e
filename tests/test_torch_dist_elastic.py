"""The elastic restart of the port on the CPU (the reference's
tests/test_distributed.py::test_elastic_restore_across_meshes): 8 gloo
ranks train one step of reduced qwen3-0.6b from the reference's
parameters on a 4 x 2 mesh (the reference's batch of 2 does not divide
the 4 data ranks: every rank keeps it whole, the reference's
replicated-batch case) and checkpoint it -- gathered, rank 0 writes
the one-device files; then ranks 0-3 as a 2 x 2 mesh restore it, each
keeping its blocks, and take the next step with the batch split.

* the 4 x 2 step against the reference's step (loss within 2e-4, each
  leaf within 1e-4 of its scale) and the port's one-device step (loss
  and grad_norm within 1e-5 relative, each leaf within 1e-4);
* the restored blocks equal the blocks of the tree the 4 x 2 run saved,
  the optimizer's step count restored;
* the 2 x 2 step's loss finite and within 1e-5 relative of the
  one-device second step, each leaf within 1e-4 of its scale.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.tree import leaves
from repro_torch.kernels import ops
from repro_torch.optim import make_optimizer
from repro_torch.train.steps import make_train_step
from tests._torch_ranks import body_elastic, run_ranks
from tests._train_ref import _reference, _trees_close

STEP = 3


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _scale_close(got, want, tol):
    want = want.float().numpy()
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got.float().numpy() - want).max()) <= tol * scale


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("elastic")
    _, tcfg, tp, tb, (_, _, _, (j_new, _, jm)) = _reference("qwen3-0.6b")
    opt_init, _ = make_optimizer(tcfg)
    step = make_train_step(tcfg, kernel_fns=ops.model_kernel_fns())
    p1, o1, m1 = step(tp, opt_init(tp), tb, STEP)
    p2, _, m2 = step(p1, o1, tb, STEP + 1)
    got = run_ranks(body_elastic, 8, tmp, {
        "params": tp, "batch": tb, "step": STEP, "ckpt": str(tmp / "ckpt")})
    return (j_new, jm, (p1, m1), (p2, m2)), got


def test_elastic_restore_across_meshes(run):
    (j_new, jm, (p1, m1), (p2, m2)), got = run
    # the 4 x 2 step
    assert abs(got["m_a"]["loss"] - float(jm["loss"])) < 2e-4
    _trees_close(got["whole_a"], j_new)
    for k in ("loss", "grad_norm"):
        assert _rel(got["m_a"][k], m1[k]) <= 1e-5, k
    for a, b in zip(leaves(got["whole_a"]), leaves(p1)):
        _scale_close(a, b, 1e-4)
    # the restore on 2 x 2
    assert got["step"] == 1 and got["opt_step"] == 1
    assert got["same"]
    # the next step there
    assert np.isfinite(got["m_b"]["loss"])
    for k in ("loss", "grad_norm"):
        assert _rel(got["m_b"][k], m2[k]) <= 1e-5, k
    for a, b in zip(leaves(got["whole_b"]), leaves(p2)):
        _scale_close(a, b, 1e-4)
