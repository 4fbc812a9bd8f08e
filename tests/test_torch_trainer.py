"""The port's data pipeline, checkpointer and trainer on the CPU, against
the reference where it has a counterpart.

* ``batch_at``: the tokens equal the reference's exactly (int32), steps
  0-3 at two shapes; ``host_slice``.
* The checkpointer: save/restore, keep-k, no partial checkpoint
  visible, async saves, a bfloat16 round trip (stored as uint16 bits).
* The trainer: failure injection and a resume equal to the
  uninterrupted run bit for bit (rtol = atol = 0), straggler flags;
  three steps of reduced qwen3-0.6b against the reference's ``Trainer``
  from the same parameters (losses within 1e-4 relative: float32 sums
  in another order, compounded over the steps); a resume from a
  checkpoint the REFERENCE wrote at step 4 against the reference's
  steps 4-7 (the same bound); ``launch.train --reduced --device cpu``.
"""
import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as JD
from repro.train import trainer as JT
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer,
                                                 latest_step, restore, save)
from repro_torch.core import convert
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import DataConfig, batch_at, host_slice
from repro_torch.launch import train as launch_train
from repro_torch.train.trainer import SimulatedFailure, Trainer, TrainerConfig

LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("vocab,seq_len,batch", [(512, 16, 4),
                                                 (151936, 33, 3)])
def test_batch_at_tokens_equal_the_reference(vocab, seq_len, batch):
    for step in range(4):
        want = JD.batch_at(JD.DataConfig(vocab=vocab, seq_len=seq_len,
                                         global_batch=batch), step)
        got = batch_at(DataConfig(vocab=vocab, seq_len=seq_len,
                                  global_batch=batch), step, device="cpu")
        for k in ("tokens", "targets"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def test_data_pipeline_deterministic_and_sharded():
    d = DataConfig(vocab=1000, seq_len=8, global_batch=8)
    a = batch_at(d, 3, device="cpu")
    assert torch.equal(a["tokens"], batch_at(d, 3, device="cpu")["tokens"])
    assert not torch.equal(a["tokens"],
                           batch_at(d, 4, device="cpu")["tokens"])
    s0, s1 = host_slice(a, 0, 2), host_slice(a, 1, 2)
    assert torch.equal(torch.cat([s0["tokens"], s1["tokens"]]),
                       a["tokens"])
    assert bool((a["tokens"] < 1000).all())


def _small_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((17, 9), generator=g),
            "b": {"c": torch.randn((3,), generator=g),
                  "d": torch.arange(5, dtype=torch.int32)},
            "layers": [{"w": torch.randn((4, 2), generator=g)
                        .to(torch.bfloat16)}, {"w": torch.zeros((4, 2))}]}


def _equal(x, y):
    xs, ys = leaves(x), leaves(y)
    assert len(xs) == len(ys)
    for a, b in zip(xs, ys):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_save_restore_roundtrip_with_bfloat16(tmp_path):
    tree = _small_tree()
    save(tmp_path, tree, step=7)
    got, step = restore(tmp_path, tree)
    assert step == 7
    _equal(got, tree)
    raw, _ = restore(tmp_path)              # the stored tree as it is
    assert raw["layers"][0]["w"].dtype == torch.bfloat16
    assert torch.equal(raw["layers"][0]["w"], tree["layers"][0]["w"])
    np.testing.assert_array_equal(raw["a"], tree["a"].numpy())
    import json
    man = json.loads((tmp_path / "step_00000007" / "manifest.json")
                     .read_text())
    assert man["dtypes"][-2] == "bfloat16"


def test_keep_k_retention(tmp_path):
    tree = _small_tree()
    for s in range(6):
        save(tmp_path, tree, step=s, keep=2)
    dirs = sorted(p.name for p in tmp_path.iterdir() if p.is_dir())
    assert dirs == ["step_00000004", "step_00000005"]


def test_no_partial_checkpoint_visible(tmp_path):
    save(tmp_path, _small_tree(), step=3)
    (tmp_path / ".tmp_step_00000009").mkdir()
    (tmp_path / "step_00000011").mkdir()      # no manifest -> incomplete
    assert latest_step(tmp_path) == 3


def test_async_checkpointer(tmp_path):
    tree = _small_tree(1)
    before = tree["a"].clone()
    ck = AsyncCheckpointer(tmp_path)
    ck.save_async(tree, 5)
    tree["a"].add_(1.0)                  # after the snapshot: not saved
    ck.wait()
    got, step = restore(tmp_path, tree)
    assert step == 5
    assert torch.equal(got["a"], before)


def _trainer(tmp_path, total=12, fail_at=None):
    cfg = dataclasses.replace(
        tconfigs.reduced(tconfigs.get_config("qwen3-0.6b")), vocab=512)
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    tc = TrainerConfig(ckpt_dir=str(tmp_path), total_steps=total,
                       ckpt_every=4, fail_at_step=fail_at)
    return Trainer(cfg=cfg, tcfg=tc, data=data, device="cpu")


def test_failure_injection_and_bitwise_resume(tmp_path):
    ref = _trainer(tmp_path / "ref", total=12)
    ref.run()
    t1 = _trainer(tmp_path / "ft", total=12, fail_at=8)
    with pytest.raises(SimulatedFailure):
        t1.run()
    assert latest_step(tmp_path / "ft") == 8
    t2 = _trainer(tmp_path / "ft", total=12)
    t2.run()
    np.testing.assert_allclose(t2.losses(), ref.losses()[8:], rtol=0,
                               atol=0)


def test_straggler_flagging(tmp_path):
    t = _trainer(tmp_path, total=6)
    t.run()
    ms = t.metrics_log
    assert all("straggler" in m for m in ms)
    assert ms[-1]["stragglers_total"] <= len(ms)


def _reference_trainer(path, total):
    cfg = dataclasses.replace(
        jconfigs.reduced(jconfigs.get_config("qwen3-0.6b")), vocab=512)
    data = JD.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    tc = JT.TrainerConfig(ckpt_dir=str(path), total_steps=total,
                          ckpt_every=4)
    return JT.Trainer(cfg=cfg, tcfg=tc, data=data)


def _close_losses(got, want):
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)


def test_trainer_vs_reference_and_resume_from_its_checkpoint(tmp_path):
    """Three steps from the reference's own initial state, then a port
    trainer resuming from the reference's step-4 checkpoint for steps
    4-7, each against the reference's losses."""
    jt = _reference_trainer(tmp_path / "ref", total=8)
    jstate = jt.init_state()
    first = jax.device_get(jstate)
    jt.run(jstate, 0)
    want = jt.losses()

    t = _trainer(tmp_path / "port3", total=3)
    params = convert.params_from_numpy(first["params"])
    state = {"params": params,
             "opt": convert.opt_state_from_numpy(first["opt"], params)}
    t.run(state, 0)
    _close_losses(t.losses(), want[:3])

    resume = tmp_path / "from_ref"
    resume.mkdir()
    shutil.copytree(tmp_path / "ref" / "step_00000004",
                    resume / "step_00000004")
    t = _trainer(resume, total=8)
    state, start = t.restore_or_init()
    assert start == 4 and int(state["opt"]["step"]) == 4
    t.run(state, start)
    _close_losses(t.losses(), want[4:8])
    assert latest_step(resume) == 8


def test_launch_train_reduced_on_the_cpu(tmp_path, capsys):
    trainer = launch_train.main([
        "--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--steps",
        "2", "--ckpt-dir", str(tmp_path), "--seq-len", "16"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "training qwen3-0.6b from step 0 on 1 device(s)"
    assert out[1].startswith("done; losses: [")
    assert len(trainer.losses()) == 2 and latest_step(tmp_path) == 2
    # the 512-rank production mesh outside such a world: refused, and
    # the message names the world's size
    with pytest.raises(ValueError, match="512 ranks; this one has 1"):
        launch_train.main(["--arch", "qwen3-8b", "--multi-pod",
                           "--ckpt-dir", str(tmp_path)])
