"""The port's examples (examples/torch_*.py), run on the CPU through
their ``main(argv)``: quickstart's loss falls over its 20 steps; the
100M-parameter trainer runs two steps at a reduced sequence and batch
(and writes its checkpoint, from which a second run resumes); the
batched server's greedy tokens equal ``launch.serve.generate``'s on the
same weights and prompts. Without ``--device`` each runs on the card,
so with none it raises."""
import math
import runpy
import shutil
from pathlib import Path

import pytest
import torch

from repro_torch.launch import serve

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("torch_quickstart", "torch_train_100m", "torch_serve_batched")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _main(name):
    return runpy.run_path(str(EXAMPLES / f"{name}.py"))["main"]


def test_quickstart_loss_falls():
    out = _main("torch_quickstart")(["--device", "cpu"])
    losses = out["losses"]
    assert len(losses) == 20 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0] - 0.5, losses
    assert len(out["decoded"]) == 12 and len(out["prompt"]) == 16


def test_train_100m_runs_and_resumes(tmp_path):
    main = _main("torch_train_100m")
    argv = ["--device", "cpu", "--seq-len", "16", "--global-batch", "2",
            "--ckpt-dir", str(tmp_path)]
    first = main(argv + ["--steps", "2"])
    assert first["start"] == 0
    assert [m["step"] for m in first["metrics"]] == [0, 1]
    assert all(math.isfinite(m["loss"]) for m in first["metrics"])
    again = main(argv + ["--steps", "3"])
    assert again["start"] == 2
    assert [m["step"] for m in again["metrics"]] == [2]
    shutil.rmtree(tmp_path)        # ~1.3 GB a checkpoint of the 100M model


def test_serve_batched_equals_generate():
    out = _main("torch_serve_batched")(["--device", "cpu"])
    want = serve.generate(out["cfg"], out["params"], out["prompts"],
                          out["tokens"].shape[1])
    assert torch.equal(out["tokens"], want["tokens"])
    assert tuple(out["tokens"].shape) == (8, 16)


@pytest.mark.parametrize("name", NAMES)
def test_examples_need_cuda_by_default(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _main(name)([])
