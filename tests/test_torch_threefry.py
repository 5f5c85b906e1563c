"""The port's threefry2x32 (``ops/threefry.py``) equals ``jax.random``.

The reference's tie-break jitter is ``jax.random.uniform(fold_in(
PRNGKey(seed), p), (N,), minval=0.0, maxval=0.5)`` under JAX's default
``jax_threefry_partitionable`` mode; the port computes the same key
words, bits and floats without JAX. Every comparison is bit for bit
(floats compared as their int32 patterns).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from open_simulator_tpu_torch.ops import threefry

SEEDS = (1, 7, 2**31 - 1)
PODS = (0, 1, 4095, 51199)
WIDTHS = (1, 3, 1024, 5120)


def _key_words(key) -> tuple:
    return tuple(int(x) for x in np.asarray(jax.random.key_data(key)))


def test_partitionable_threefry_is_the_reference_mode():
    """The counter layout the port copies is the partitionable mode's."""
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS + (0, -3, 2**32 + 5))
def test_prng_key_words(seed):
    assert threefry.prng_key(seed) == _key_words(jax.random.PRNGKey(seed))


def test_threefry2x32_equals_the_reference_hash():
    from jax._src import prng

    rng = np.random.RandomState(3)
    k = rng.randint(0, 2**32, size=2, dtype=np.uint64)
    x0, x1 = (rng.randint(0, 2**32, size=257, dtype=np.uint64) for _ in range(2))
    want = prng.threefry2x32_p.bind(jnp.uint32(k[0]), jnp.uint32(k[1]),
                                    jnp.asarray(x0, jnp.uint32), jnp.asarray(x1, jnp.uint32))
    got = threefry.threefry2x32(int(k[0]), int(k[1]), torch.from_numpy(x0.astype(np.int64)),
                                torch.from_numpy(x1.astype(np.int64)))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w).astype(np.int64), g.numpy())


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("pod", PODS)
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bits_and_uniform_equal_jax(seed, pod, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), pod)
    port_key = threefry.fold_in(threefry.prng_key(seed), pod)
    assert port_key == _key_words(key)
    bits = np.asarray(jax.random.bits(key, (n,)))
    assert np.array_equal(bits.astype(np.int64), threefry.random_bits(port_key, n).numpy())
    want = np.asarray(jax.random.uniform(key, (n,), minval=0.0, maxval=0.5))
    got = threefry.tie_break_jitter(seed, pod, n).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(want.view(np.int32), got.view(np.int32))
    assert (got >= 0.0).all() and (got < 0.5).all()


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(min_value=-2**31, max_value=2**31 - 1),
       pod=st.integers(min_value=0, max_value=2**31 - 1),
       n=st.integers(min_value=1, max_value=70))
def test_jitter_equals_jax_on_random_keys(seed, pod, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), pod)
    want = np.asarray(jax.random.uniform(key, (n,), minval=0.0, maxval=0.5))
    got = threefry.tie_break_jitter(seed, pod, n).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))
