"""The port's threefry PRNG (repro_torch/core/prng.py) against jax.random.

Uniform draws are held bit for bit (every uint32 word, every float32
uniform) at every draw width the simulator step uses, in both of JAX's
threefry counter schemes. Normals go through the erfinv polynomial, whose
log1p differs from XLA's in the last bit now and then: they are held to
4 float32 ulp, and at least 98% must be bit-identical (measured: 99.0%
over a grid of 1.2M uniforms, max 3 ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constants as JC
from repro.core import simulator as JS
from repro_torch.core import prng

SCHEMES = [True, False]
# every fixed draw width of the step: the rack block, the normal pair,
# the fault blocks, the plane-hazard block, the flow-size block, and
# an odd and a length-1 width for the original scheme's padding
WIDTHS = [5 + JS.F_SLOTS, 2, 2 + JS.MAX_FAULT_LINKS, JS.MAX_FAULT_LINKS,
          JC.MAX_INCAST_DEGREE, 3, 1]
SEEDS = [0, 3, 8, 9, 12345, -1, 2**32 + 5]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs tiny tensors on the CPU here: PyTorch's intra-op
    threads only contend (with each other and with the other test
    workers), so this module runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(jkey):
    return np.asarray(jkey).astype(np.int64)


@pytest.mark.parametrize("partitionable", SCHEMES)
def test_key_split_fold_in_exact(partitionable):
    with jax.threefry_partitionable(partitionable):
        for seed in SEEDS:
            jk = jax.random.PRNGKey(jnp.asarray(seed & 0xFFFFFFFF,
                                                jnp.uint32))
            tk = prng.key(seed)
            np.testing.assert_array_equal(tk.numpy(), _words(jk))
            for n in (2, 3, 7):
                np.testing.assert_array_equal(
                    prng.split(tk, n, partitionable).numpy(),
                    _words(jax.random.split(jk, n)))
            for d in (0, 5, 0x7F000001, 0x7F000006):
                np.testing.assert_array_equal(
                    prng.fold_in(tk, d).numpy(),
                    _words(jax.random.fold_in(jk, d)))


@pytest.mark.parametrize("partitionable", SCHEMES)
@pytest.mark.parametrize("n", WIDTHS)
def test_bits_and_uniforms_exact(partitionable, n):
    with jax.threefry_partitionable(partitionable):
        keys = jax.random.split(jax.random.PRNGKey(7), 64)
        jbits = np.asarray(jax.vmap(
            lambda k: jax.random.bits(k, (n,), jnp.uint32))(keys))
        juni = np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, (n,)))(keys))
    tkeys = torch.as_tensor(_words(keys))
    np.testing.assert_array_equal(
        prng.random_bits(tkeys, n, partitionable).numpy(),
        jbits.astype(np.int64))
    tuni = prng.uniform(tkeys, n, partitionable).numpy()
    np.testing.assert_array_equal(tuni.view(np.uint32),
                                  juni.view(np.uint32))


def test_batched_fold_in_matches_vmap():
    """The step folds logical switch ids into per-scenario keys in one
    broadcast call; that equals the reference's vmap of fold_in."""
    rng = np.random.default_rng(0)
    keys = jax.random.split(jax.random.PRNGKey(11), 5)
    uids = rng.integers(0, 2**31 - 1, (5, 33)).astype(np.int32)
    want = jax.vmap(lambda k, u: jax.vmap(
        lambda i: jax.random.fold_in(k, i))(u))(keys, uids)
    got = prng.fold_in(torch.as_tensor(_words(keys))[:, None, :],
                       torch.as_tensor(uids))
    np.testing.assert_array_equal(got.numpy(), _words(want))


def test_normals_within_4_ulp():
    keys = jax.random.split(jax.random.PRNGKey(8), 20000)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (2,)))(keys))
    got = prng.normal(torch.as_tensor(_words(keys)), 2).numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= 4 * ulp)
    assert np.mean(got == want) >= 0.98


def test_erfinv_grid_within_4_ulp():
    """Every 7th float32 uniform the generator can produce, through the
    normal transform, against XLA's erf_inv."""
    bits = np.arange(0, 2**23, 7, dtype=np.int64) << 9
    u01 = prng.bits_to_unit(torch.as_tensor(bits))
    got = prng.unit_to_normal(u01).numpy()
    x = torch.clamp(u01 * 2.0 + prng._NORMAL_LO, min=prng._NORMAL_LO)
    want = np.asarray(np.float32(np.sqrt(2))
                      * jax.lax.erf_inv(jnp.asarray(x.numpy())))
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= 4 * ulp)
    assert np.mean(got == want) >= 0.98
