"""The port's Fig 7 traffic-fidelity functions (core/traffic.py) against
the reference's, and tests/test_traffic.py's checks on the port.

* ``sample_flow_sizes`` / ``sample_intervals`` for seeds 0, 1 and 7 in
  both of JAX's threefry schemes, every trace: the mixture pick (a
  uniform below ``size_w``) bit for bit; sizes and intervals within
  ``RTOL``. The reference calls them eagerly, so ``mu + s * z`` rounds
  twice there as here; what differs is the normal (4 ulp at most,
  tests/test_torch_prng.py) and ``exp``'s last bit between libraries.
  Both reach the result through the exponent ``mu + s * z`` (|.| < 32,
  whose float32 ulp is 1.9e-6 relative in ``exp``): measured at most
  1.97e-6 (16 float32 ulp) over these draws, 90% of values bit-exact.
* Pearson r of 200,000 draws per trace against ``TARGET_CDFS`` (keys 0
  and 1, as tests/test_traffic.py draws them): sizes >= 0.95, intervals
  >= 0.89, the reference's bands; and the port's r equal to the
  reference's on the reference's own draws.
* ``TARGET_CDFS``, ``empirical_cdf_at`` and ``pearson_vs_target``
  exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import traffic as JT
from repro_torch.core import prng
from repro_torch.core import traffic as T

RTOL = 4e-6
SEEDS = (0, 1, 7)
SCHEMES = (True, False)
N = 20_000
N_FIT = 200_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(seed):
    return prng.key(seed, device="cpu")


def _pick(seed, spec, n, partitionable):
    k1 = prng.split(_key(seed), 3, partitionable)[0]
    return (prng.uniform(k1, n, partitionable)
            < torch.tensor(spec.size_w, dtype=torch.float32)).numpy()


@pytest.mark.parametrize("partitionable", SCHEMES)
@pytest.mark.parametrize("trace", list(JT.TRAFFIC_SPECS))
def test_samplers_match_the_reference(trace, partitionable):
    spec, jspec = T.TRAFFIC_SPECS[trace], JT.TRAFFIC_SPECS[trace]
    with jax.threefry_partitionable(partitionable):
        for seed in SEEDS:
            jk = jax.random.PRNGKey(seed)
            jpick = np.asarray(jax.random.bernoulli(
                jax.random.split(jk, 3)[0], jspec.size_w, (N,)))
            np.testing.assert_array_equal(
                _pick(seed, spec, N, partitionable), jpick)
            sizes = T.sample_flow_sizes(_key(seed), spec, N,
                                        partitionable=partitionable)
            assert sizes.dtype == torch.float32
            np.testing.assert_allclose(
                sizes.numpy(), np.asarray(JT.sample_flow_sizes(jk, jspec, N)),
                rtol=RTOL, atol=0)
            iat = T.sample_intervals(_key(seed), spec, N,
                                     partitionable=partitionable)
            np.testing.assert_allclose(
                iat.numpy(), np.asarray(JT.sample_intervals(jk, jspec, N)),
                rtol=RTOL, atol=0)


@pytest.mark.parametrize("trace", list(JT.TRAFFIC_SPECS))
def test_pearson_fits_the_published_cdfs(trace):
    """tests/test_traffic.py's bands at 200,000 draws (paper: r in
    0.979-0.992 for sizes, 0.894-0.998 for intervals)."""
    spec = T.TRAFFIC_SPECS[trace]
    sizes = T.sample_flow_sizes(_key(0), spec, N_FIT).numpy()
    iat = T.sample_intervals(_key(1), spec, N_FIT).numpy()
    r_size = T.pearson_vs_target(sizes, T.TARGET_CDFS[trace]["size"])
    r_iat = T.pearson_vs_target(iat, T.TARGET_CDFS[trace]["interval"])
    assert r_size >= 0.95, f"{trace}: r={r_size:.4f}"
    assert r_iat >= 0.89, f"{trace}: r={r_iat:.4f}"
    jsizes = np.asarray(JT.sample_flow_sizes(jax.random.PRNGKey(0),
                                             JT.TRAFFIC_SPECS[trace], N_FIT))
    want = JT.pearson_vs_target(jsizes, JT.TARGET_CDFS[trace]["size"])
    assert T.pearson_vs_target(jsizes, T.TARGET_CDFS[trace]["size"]) == want
    assert abs(r_size - want) <= 1e-4


def test_fidelity_functions_exact():
    assert T.TARGET_CDFS == JT.TARGET_CDFS
    rng = np.random.default_rng(5)
    samples = rng.lognormal(8.0, 2.0, 5_000)
    xs = np.array([10.0, 1e3, 3e3, 1e5, 1e9])
    np.testing.assert_array_equal(T.empirical_cdf_at(samples, xs),
                                  JT.empirical_cdf_at(samples, xs))
    for trace, anchors in T.TARGET_CDFS.items():
        for kind in ("size", "interval"):
            assert T.pearson_vs_target(samples, anchors[kind]) \
                == JT.pearson_vs_target(samples, anchors[kind])
    # an empirical CDF flat over the anchors has no spread: r is 0
    flat = np.full(100, 1e3)
    anchors = [(1.0, 0.2), (10.0, 0.7)]
    assert T.pearson_vs_target(flat, anchors) \
        == JT.pearson_vs_target(flat, anchors) == 0.0


def test_sampler_determinism_and_tail():
    spec = T.TRAFFIC_SPECS["fb_web"]
    a = T.sample_flow_sizes(_key(7), spec, 1000)
    b = T.sample_flow_sizes(_key(7), spec, 1000)
    assert torch.equal(a, b)
    s = T.sample_flow_sizes(_key(0), T.TRAFFIC_SPECS["fb_hadoop"],
                            100_000).numpy()
    assert (s > 0).all()
    assert np.median(s) < 10_000 and np.quantile(s, 0.995) > 100_000


def test_samplers_take_no_device_of_their_own():
    """They draw on their key's device: a CPU key gives CPU samples, and
    the keyword-only options are the sweep's (``partitionable``, ``x64``)."""
    spec = T.TRAFFIC_SPECS["university"]
    assert T.sample_intervals(_key(3), spec, 4).device.type == "cpu"
    assert T.sample_flow_sizes(_key(3), spec, 4, x64=True).dtype \
        == torch.float64
