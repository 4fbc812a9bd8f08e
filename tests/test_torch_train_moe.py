"""The port's training step against the reference for the MLA, MoE and
hybrid families, on the CPU: reduced float32 minicpm3-4b (MLA),
mixtral-8x7b (MoE, sliding window), jamba-v0.1-52b (at 2 layers: a
Mamba + MLP layer, then attention + MoE; ``_train_ref.OVERRIDES``) and
kimi-k2-1t-a32b (a dense prefix layer, then MoE; adafactor). The
checks and tolerances are tests/test_torch_train.py's
(tests/_train_ref.py): the loss within 1e-5 relative and every
gradient leaf within 1e-4 of its scale against
``jax.value_and_grad(repro.models.model.train_loss)``, then one
``make_train_step`` against the reference's (the MoE aux loss in both).
"""
import pytest

from tests._train_ref import (check_loss_and_grads, check_train_step,
                              one_thread)  # noqa: F401

ARCHS = ["minicpm3-4b", "mixtral-8x7b", "jamba-v0.1-52b",
         "kimi-k2-1t-a32b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_vs_reference(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_vs_reference(arch):
    check_train_step(arch)
