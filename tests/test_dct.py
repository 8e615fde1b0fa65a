"""DCT kernel tests: mathematical correctness of the float32 AAN
butterflies against a float64 textbook DCT, plus round-trip accuracy.
"""

import numpy as np
import pytest

from jpeglibrary_tpu.ops import dct


def _dct_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix (float64)."""
    k = np.arange(8)
    n = np.arange(8)
    m = np.cos(np.pi * (2 * n[None, :] + 1) * k[:, None] / 16.0)
    m[0] *= 1 / np.sqrt(2)
    return m * 0.5


def _reference_fdct(blocks: np.ndarray) -> np.ndarray:
    m = _dct_matrix()
    return np.einsum("ij,njk,lk->nil", m, blocks.astype(np.float64), m)


def _reference_idct(blocks: np.ndarray) -> np.ndarray:
    m = _dct_matrix()
    return np.einsum("ji,njk,kl->nil", m, blocks.astype(np.float64), m)


@pytest.fixture(scope="module")
def random_blocks():
    rng = np.random.default_rng(42)
    return rng.integers(-1024, 1024, size=(64, 8, 8)).astype(np.float32)


def test_idct_matches_textbook(random_blocks):
    ours = dct.idct8x8(random_blocks)
    ref = _reference_idct(random_blocks)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=0.01)


def test_fdct_matches_textbook(random_blocks):
    ours = dct.fdct8x8(random_blocks)
    ref = _reference_fdct(random_blocks)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=0.01)


def test_roundtrip(random_blocks):
    back = dct.idct8x8(dct.fdct8x8(random_blocks))
    np.testing.assert_allclose(back, random_blocks, rtol=0, atol=0.02)


def test_jax_matches_numpy_bitexact(random_blocks):
    """XLA:CPU must produce bit-identical float32 results."""
    import jax.numpy as jnp

    ours_np = dct.idct8x8(random_blocks)
    ours_jax = np.asarray(dct.idct8x8(jnp.asarray(random_blocks), xp=jnp))
    np.testing.assert_array_equal(ours_np, ours_jax)

    f_np = dct.fdct8x8(random_blocks)
    f_jax = np.asarray(dct.fdct8x8(jnp.asarray(random_blocks), xp=jnp))
    np.testing.assert_array_equal(f_np, f_jax)


def test_jit_matches_numpy_bitexact(random_blocks):
    """The jitted butterfly matches numpy to within FMA contraction.

    On every backend XLA may contract mul+add chains into FMAs under
    jit (the GPU backend as well as LLVM's ffp-contract on the CPU),
    introducing <=1-ulp drift before rounding; that drift is what the
    device path's <=1 sample LSB contract
    (jpeglibrary_tpu.utils.tolerance) covers. Exact equality is not
    promised on any backend, so this asserts near-equality everywhere.
    """
    import jax
    import jax.numpy as jnp

    jitted = jax.jit(lambda x: dct.idct8x8(x, xp=jnp))
    ours = dct.idct8x8(random_blocks)
    theirs = np.asarray(jitted(random_blocks))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-3)
