"""whisper_tpu_torch.decode.rng against jax.random on the same raw uint32
keys: threefry bits, split keys (single and vmapped) and uniforms bit for
bit; Gumbel noise to 1e-6 (XLA's log on the CPU is not torch's, so a value
may differ by an ulp or two); and the three categorical forms whisper_tpu
samples with, asserted equal only where the top-2 gap of logits + noise
exceeds 1e-5, which the test checks, so that an equal draw is no luck."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from whisper_tpu_torch.decode import rng  # noqa: E402

# window_rng-style keys: (seek, attempt << 8 | candidate), and two words
# with the top bit set
KEYS = [np.array(k, np.uint32) for k in
        ((0, 0), (4500, (2 << 8) + 3), (2**31 + 7, 2**32 - 1))]
GAP = 1e-5


def _i64(a):
    return np.asarray(a).astype(np.int64)


def test_partitionable_threefry_is_what_the_port_encodes():
    """The port encodes JAX's partitionable threefry; a JAX that changed
    the default would draw other numbers from the same keys."""
    assert rng.THREEFRY_PARTITIONABLE is True
    assert bool(jax.config.jax_threefry_partitionable) is True
    assert not jax.config.jax_high_dynamic_range_gumbel


@pytest.mark.parametrize("key", KEYS, ids=str)
def test_bits_split_uniform_exact(key):
    for shape in ((1,), (7,), (3, 5), (2, 3, 33)):
        np.testing.assert_array_equal(rng.random_bits(key, shape).numpy(),
                                      _i64(jax.random.bits(key, shape)))
        np.testing.assert_array_equal(
            rng.uniform(key, shape).numpy(),
            np.asarray(jax.random.uniform(key, shape)))
        np.testing.assert_array_equal(
            rng.uniform(key, shape, rng._TINY, 1.0).numpy(),
            np.asarray(jax.random.uniform(key, shape, minval=rng._TINY,
                                          maxval=1.0)))
        # another range: XLA fuses the scale and the shift into one FMA
        # on the CPU, torch rounds twice (whisper_tpu draws only from
        # [tiny, 1), where the scale is 1.0 and both agree)
        np.testing.assert_allclose(
            rng.uniform(key, shape, 1e-3, 2.5).numpy(),
            np.asarray(jax.random.uniform(key, shape, minval=1e-3,
                                          maxval=2.5)), rtol=2.5e-7)
    for num in (2, 3):
        np.testing.assert_array_equal(rng.split(key, num).numpy(),
                                      _i64(jax.random.split(key, num)))
    # a key chain as the decode loop advances it
    k_jax, k_port = key, key
    for _ in range(4):
        k_jax = jax.random.split(k_jax)[0]
        k_port = rng.split(k_port)[0]
    np.testing.assert_array_equal(k_port.numpy(), _i64(k_jax))


def test_vmapped_split_and_bits_exact():
    keys = np.stack(KEYS)
    np.testing.assert_array_equal(rng.split(keys).numpy(),
                                  _i64(jax.vmap(jax.random.split)(keys)))
    np.testing.assert_array_equal(
        rng.random_bits(keys, (4, 9)).numpy(),
        _i64(jax.vmap(lambda k: jax.random.bits(k, (4, 9)))(keys)))


@pytest.mark.parametrize("key", KEYS, ids=str)
def test_gumbel_close(key):
    shape = (64, 1000)
    got = rng.gumbel(key, shape).numpy()
    want = np.asarray(jax.random.gumbel(key, shape))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _logits(seed, shape):
    """Logits with a third of each row suppressed to -inf, as the filter
    chain leaves them."""
    r = np.random.RandomState(seed)
    lg = (r.randn(*shape) * 2.0).astype(np.float32)
    lg[..., r.rand(shape[-1]) < 0.3] = -np.inf
    return lg


def _assert_clear(noise_plus_logits):
    """Every draw's winner leads the runner-up by more than GAP (JAX's own
    noise here; the port's agrees, rng.categorical_margin)."""
    top2 = np.sort(noise_plus_logits, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    assert gap.min() > GAP, gap.min()
    return float(gap.min())


@pytest.mark.parametrize("seed", [0, 1])
def test_categorical_one_key_over_rows(seed):
    """decode/loop.py's legacy form: one (2,) key over (B, V)."""
    key = KEYS[seed + 1]
    lg = _logits(seed, (4, 51865))
    want = np.asarray(jax.random.categorical(key, lg, axis=-1))
    got = rng.categorical(key, torch.from_numpy(lg)).numpy()
    gap = _assert_clear(np.asarray(jax.random.gumbel(key, lg.shape)) + lg)
    np.testing.assert_array_equal(got, want)
    assert abs(rng.categorical_margin(key, torch.from_numpy(lg)) - gap) \
        < 1e-5


@pytest.mark.parametrize("seed", [0, 1])
def test_categorical_per_row_keys(seed):
    """The serving ladder's form: (B, 2) per-row keys under vmap."""
    keys = np.stack([KEYS[1] + np.uint32(i) for i in range(5)])
    lg = _logits(seed + 2, (5, 51865))
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, lg))
    got = rng.categorical(keys, torch.from_numpy(lg)).numpy()
    noise = np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (lg.shape[-1],)))(keys))
    _assert_clear(noise + lg)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("K", [3, 5])
def test_categorical_beam_shapes(K):
    """Both beam windows' form: shape (K, K) over (K, V), from one key and
    under vmap over per-stream keys (S, 2) with logits (S, K, V)."""
    key = KEYS[2]
    lg = _logits(K, (K, 51865))
    want = np.asarray(jax.random.categorical(key, lg, axis=-1,
                                             shape=(K, K)))
    got = rng.categorical(key, torch.from_numpy(lg), (K, K)).numpy()
    _assert_clear(np.asarray(jax.random.gumbel(key, (K, K, lg.shape[-1])))
                  + lg[None])
    np.testing.assert_array_equal(got, want)

    keys = np.stack([KEYS[1], KEYS[2]])
    lgs = _logits(K + 1, (2, K, 51865))
    want = np.asarray(jax.vmap(lambda k, x: jax.random.categorical(
        k, x, axis=-1, shape=(K, K)))(keys, lgs))
    got = rng.categorical(keys, torch.from_numpy(lgs), (K, K)).numpy()
    noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (K, K, lgs.shape[-1])))(keys))
    _assert_clear(noise + lgs[:, None])
    np.testing.assert_array_equal(got, want)


def test_categorical_rejects_a_bad_shape():
    with pytest.raises(ValueError, match="batch shape"):
        rng.categorical(KEYS[0], torch.zeros(3, 10), (3, 2))


def test_keys_from_torch_and_numpy_agree():
    """A key handed over as a torch tensor (the loop's carried keys) draws
    what the same numpy words draw."""
    key = KEYS[2]
    tk = rng.as_key(key)
    assert tk.dtype == torch.int64
    np.testing.assert_array_equal(rng.random_bits(tk, (5,)).numpy(),
                                  rng.random_bits(key, (5,)).numpy())
    assert jnp.asarray(key).dtype == jnp.uint32
