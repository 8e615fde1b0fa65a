"""Fused dequantize + IDCT + level shift for the GPU: a Pallas kernel
through the Triton route.

The un-zigzag permutation, both 1-D IDCT passes and the x0.125 scale
are linear, so they fold into one [64, 64] matrix K, and the transform
of a tile of blocks becomes one matrix product:

    samples[t, :] = rint((coeff[t, :] * quant[:]) @ K) + level_shift
    K[zz, 8*i+j]  = 0.125 * M[i, r(zz)] * M[j, c(zz)]

where M is the exact linear map of the reference's 1-D AAN butterfly
(FastFloatingPointDCT.cs:54-196) and (r, c) is the natural position of
zig-zag index zz. The elementwise float32 dequant multiply rounds
exactly like the reference's int-product-to-float conversion. The
product runs at full float32 precision (``Precision.HIGHEST``: IEEE
FMAs, not TF32), so samples match the butterfly within 1 LSB after
rounding; the butterfly (``ops.decode_stage``) stays the bit-exact
reference and the path on every other backend.

On the H100 the whole v2 transform program ran faster with this kernel
than with XLA's own fusion of the butterfly, at every tile size tried
(PERF.md, Findings), which is why ``ops.pipeline`` selects it on a GPU.
"""

from __future__ import annotations

import functools

import numpy as np

from . import dct
from .zigzag import ZIGZAG_TO_BLOCK

#: Blocks per program instance (Triton block shapes are powers of two;
#: 64 was the fastest of 64, 128 and 256 on the H100).
TILE = 64
#: Warps per program instance.
NUM_WARPS = 4


@functools.lru_cache(maxsize=1)
def fused_transform_matrix() -> np.ndarray:
    """[64, 64] f32: un-zigzag + 2-D IDCT + 0.125 scale folded."""
    m = dct._idct_1d(np.eye(8, dtype=np.float64), np)  # out = 0.125 * M @ X @ M.T
    k = np.zeros((64, 64), dtype=np.float64)
    for zz in range(64):
        nat = int(ZIGZAG_TO_BLOCK[zz])
        r, c = nat // 8, nat % 8
        for i in range(8):
            for j in range(8):
                k[zz, 8 * i + j] = 0.125 * m[i, r] * m[j, c]
    return k.astype(np.float32)


def round_half_even(x):
    """``rint`` from floor and selects (the Triton route lowers no
    rounding primitive)."""
    import jax.numpy as jnp

    f = jnp.floor(x)
    d = x - f
    odd = (f - 2.0 * jnp.floor(f * 0.5)) != 0.0
    return jnp.where((d > 0.5) | ((d == 0.5) & odd), f + 1.0, f)


def _kernel(coeff_ref, quant_ref, matrix_ref, out_ref, *, level_shift: int):
    import jax
    import jax.numpy as jnp

    deq = coeff_ref[...].astype(jnp.float32) * quant_ref[...].astype(jnp.float32)
    pixels = jax.lax.dot_general(
        deq,
        matrix_ref[...],
        dimension_numbers=(((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    out_ref[...] = round_half_even(pixels).astype(jnp.int32) + level_shift


def dequantize_idct_shift(coeffs_zz, quant_zz, level_shift: int, *, interpret: bool = False):
    """[..., 64] zig-zag coefficients + [64] zig-zag quant -> int32
    samples [..., 8, 8]: the device twin of
    ``decode_stage.dequantize_idct_shift`` (within 1 LSB). ``interpret``
    runs the kernel through the Pallas interpreter (tests on the CPU)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pl_triton

    lead = coeffs_zz.shape[:-1]
    flat = coeffs_zz.reshape(-1, 64).astype(jnp.int32)
    n = flat.shape[0]
    pad = (-n) % TILE
    if pad:
        flat = jnp.concatenate([flat, jnp.zeros((pad, 64), dtype=jnp.int32)], axis=0)
    call = pl.pallas_call(
        functools.partial(_kernel, level_shift=int(level_shift)),
        grid=(flat.shape[0] // TILE,),
        in_specs=[
            pl.BlockSpec((TILE, 64), lambda i: (i, 0)),
            pl.BlockSpec((1, 64), lambda i: (0, 0)),
            pl.BlockSpec((64, 64), lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((TILE, 64), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct(flat.shape, jnp.int32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="dequant_idct_shift",
    )
    quant = quant_zz.astype(jnp.int32).reshape(1, 64)
    out = call(flat, quant, jnp.asarray(fused_transform_matrix()))
    return out[:n].reshape(lead + (8, 8))
