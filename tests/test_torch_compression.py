"""The port's gradient compression (``repro_torch.distributed
.compression``) against the reference's on the same numpy inputs.

* ``quantize_int8``: ``q`` and ``scale`` equal to the bit (both
  frameworks round half to even and divide in float32), at several
  scales and shapes, a zero tensor (the 1e-12 floor) and values on the
  rounding ties; ``dequantize_int8`` equal to the bit.
* ``compress_grads`` over a tree with a float32 and a bfloat16 leaf:
  the compressed gradients and the new residuals equal to the bit over
  three steps of error feedback; ``ef_state_init`` gives float32 zeros.
* The error-feedback property of tests/test_compression_optim.py: over
  50 steps the compressed gradients' sum stays within one quantization
  step of the true sum.
* The half-step bound of the round trip.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as J
from repro_torch.core.tree import leaves
from repro_torch.distributed import compression as T


def _bits_equal(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.reshape(-1).view(np.uint8),
                          want.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("shape,scale,seed", [
    ((64,), 3.0, 0), ((32, 8), 0.01, 1), ((4, 5, 6), 1e4, 2),
    ((1,), 1.0, 3), ((256, 33), 1e-6, 4)])
def test_quantize_int8_equals_the_reference(shape, scale, seed):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)
    jq, js = J.quantize_int8(jnp.asarray(x))
    tq, ts = T.quantize_int8(torch.as_tensor(x))
    _bits_equal(tq, jq)
    _bits_equal(ts, js)
    _bits_equal(T.dequantize_int8(tq, ts), J.dequantize_int8(jq, js))


def test_quantize_int8_zeros_and_ties():
    zeros = np.zeros((16,), np.float32)
    for x in (zeros, np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5],
                              np.float32)):
        jq, js = J.quantize_int8(jnp.asarray(x))
        tq, ts = T.quantize_int8(torch.as_tensor(x))
        _bits_equal(tq, jq)
        _bits_equal(ts, js)


def test_quantize_roundtrip_error_bound():
    for seed in range(20):
        x = torch.as_tensor((np.random.default_rng(seed)
                             .standard_normal(64) * 3.0).astype(np.float32))
        q, s = T.quantize_int8(x)
        err = torch.max(torch.abs(T.dequantize_int8(q, s) - x))
        assert float(err) <= float(s) / 2 + 1e-6


def test_compress_grads_equals_the_reference_over_steps():
    rng = np.random.default_rng(5)
    shapes = {"a": (32, 8), "b": (7,)}
    t_ef = T.ef_state_init({k: torch.zeros(s) for k, s in shapes.items()})
    assert all(x.dtype == torch.float32 and not x.any()
               for x in leaves(t_ef))
    j_ef = J.ef_state_init({k: jnp.zeros(s) for k, s in shapes.items()})
    for _ in range(3):
        g = {k: (rng.standard_normal(s) * 0.01).astype(np.float32)
             for k, s in shapes.items()}
        # a bfloat16 leaf: the same values on both sides
        tg = {"a": torch.as_tensor(g["a"]),
              "b": torch.as_tensor(g["b"]).to(torch.bfloat16)}
        jg = {"a": jnp.asarray(g["a"]),
              "b": jnp.asarray(tg["b"].float().numpy()).astype(jnp.bfloat16)}
        tc, t_ef = T.compress_grads(tg, t_ef)
        jc, j_ef = J.compress_grads(jg, j_ef)
        _bits_equal(tc["a"], jc["a"])
        assert tc["b"].dtype == torch.bfloat16
        _bits_equal(tc["b"].float(), np.asarray(jc["b"]).astype(np.float32))
        for k in shapes:
            _bits_equal(t_ef[k], j_ef[k])


def test_error_feedback_preserves_sum():
    """With EF the accumulated compressed gradients track the true sum:
    the residual stays within one quantization step, not O(steps)."""
    rng = np.random.default_rng(0)
    grads = [{"w": torch.as_tensor((rng.standard_normal((32, 8)) * 0.01)
                                   .astype(np.float32))} for _ in range(50)]
    ef = T.ef_state_init(grads[0])
    acc_c = torch.zeros((32, 8))
    acc_t = torch.zeros((32, 8))
    for g in grads:
        cg, ef = T.compress_grads(g, ef)
        acc_c += cg["w"]
        acc_t += g["w"]
    resid = float(torch.max(torch.abs(acc_c - acc_t)))
    onestep = float(torch.max(torch.abs(leaves(ef)[0])))
    assert resid <= onestep + 1e-5
