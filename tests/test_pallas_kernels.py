"""The GPU dequant + IDCT kernel (ops/idct_kernel.py, Pallas through the
Triton route), run in interpreter mode on the CPU test platform; on a
GPU, chip_smoke.py runs it compiled inside every decode program. Also
the device encode transform, which has no kernel of its own.

The kernel's folded matrix product sums in another order than the
butterfly, so a sample on a .5 rounding tie may round the other way:
|diff| <= 1 sample LSB.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jpeglibrary_tpu.ops import decode_stage, idct_kernel, pipeline


@pytest.mark.parametrize("n_blocks", [1, 64, 513])
def test_fused_kernel_matches_reference(n_blocks):
    rng = np.random.default_rng(5)
    coeffs = rng.integers(-1024, 1024, size=(n_blocks, 64)).astype(np.int16)
    quant = rng.integers(1, 255, size=64).astype(np.int32)
    ref = decode_stage.dequantize_idct_shift(coeffs, quant, 128)
    out = np.asarray(
        idct_kernel.dequantize_idct_shift(
            jnp.asarray(coeffs), jnp.asarray(quant), 128, interpret=True
        )
    )
    assert out.shape == ref.shape
    assert np.abs(out.astype(np.int64) - ref.astype(np.int64)).max() <= 1


def test_fused_kernel_plane_shape():
    rng = np.random.default_rng(6)
    coeffs = rng.integers(-64, 64, size=(12, 10, 64)).astype(np.int16)
    quant = np.full(64, 16, dtype=np.int32)
    out = np.asarray(
        idct_kernel.dequantize_idct_shift(
            jnp.asarray(coeffs), jnp.asarray(quant), 128, interpret=True
        )
    )
    assert out.shape == (12, 10, 8, 8)


def test_round_half_even_matches_rint():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 2.4999998, 2.5000002, 7.0, -3.2],
                 dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(idct_kernel.round_half_even(jnp.asarray(x))), np.rint(x))


@pytest.mark.parametrize("backend,xp_name,kernel", [
    ("gpu", "jnp", True), ("cpu", "jnp", False), ("gpu", "np", False),
])
def test_kernel_selected_only_for_gpu_programs(monkeypatch, backend, xp_name, kernel):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    chosen = pipeline._block_transform(jnp if xp_name == "jnp" else np)
    assert (chosen is idct_kernel.dequantize_idct_shift) == kernel


def test_batched_v2_program_with_kernel(monkeypatch, photo_jpegs):
    """The vmapped v2 batch program with the kernel in place of the
    butterfly stays within the device contract of the host path."""
    import jpeglibrary_tpu as jt
    from jpeglibrary_tpu.models.decoder import JpegDecoder
    from jpeglibrary_tpu.parallel.batch import _stack_payloads2, _stacked_quants
    from jpeglibrary_tpu.utils.tolerance import rgb_mismatch

    monkeypatch.setattr(
        pipeline, "_block_transform",
        lambda xp: functools.partial(idct_kernel.dequantize_idct_shift, interpret=True),
    )
    blob = photo_jpegs[1]
    dec = JpegDecoder()
    dec.set_input(blob)
    res = dec.decode(sparse_direct=True)
    geo = res.geometry
    inner = pipeline.jitted_transform_mcu2_inner.__wrapped__(geo, "rgb8", "duplicate", 8)
    out = jax.jit(jax.vmap(inner))(_stack_payloads2([res, res], geo), _stacked_quants([res, res], geo))
    host = np.moveaxis(jt.decode(blob).to_rgb8(), -1, 0)
    for img in np.asarray(out):
        rgb_mismatch(img, host, "kernel batch")


def test_device_encode_transform_uses_kernel_consistently(photos):
    """The jitted device encode transform (folded FDCT at full float32
    precision) stays within 1 LSB of the host coefficients."""
    import jpeglibrary_tpu as jt
    from jpeglibrary_tpu.models.encoder import encode_rgb

    rgb = photos[1]
    a = jt.decode(encode_rgb(rgb, 80))
    b = jt.decode(encode_rgb(rgb, 80, xp=jnp))
    for k in a.coefficients:
        d = np.abs(a.coefficients[k].astype(int) - b.coefficients[k].astype(int))
        assert d.max() <= 1
