"""The device-vs-host RGB contract.

The host path (``DecodeResult.to_rgb8``, numpy) is the bit-exact golden
path. A compiled device program runs the same float32 arithmetic, but
XLA may contract a multiply-add into an FMA or sum in another order,
which moves an IDCT output by about 1 ulp. A sample whose true value
sits on a .5 rounding tie can then round the other way: 1 sample LSB,
which the YCbCr->RGB matrix amplifies to at most 2 RGB levels (the
Cb->B coefficient is 1.772). Ties are rare, so at most a 1e-4 share of
pixels may differ. A real transform bug (wrong quant table, block index
or upsample alignment) moves whole 8x8 blocks by many levels and fails
both bounds.

Scaled decode is the exception: the dequantised coefficients are
integers and the block-mean weight is 1/8, so its outputs often sit
within an ulp of a .5 tie; ties are common there and can meet in one
pixel. 1 sample LSB in each of Y, Cb and Cr then moves an
RGB value by up to 3 levels (``MAX_ABS_ALL_COMPONENTS``), and the share
of differing values is not bounded.
"""

from __future__ import annotations

import numpy as np

#: Largest |device - host| difference of one RGB value.
MAX_ABS = 2
#: The same when every component may be 1 sample LSB off.
MAX_ABS_ALL_COMPONENTS = 3
#: Largest share of RGB values that may differ at all.
MAX_FRACTION = 1e-4


def rgb_mismatch(got, want, what: str = "rgb", *, max_abs: int = MAX_ABS,
                 max_fraction: float = MAX_FRACTION) -> int:
    """Check two same-layout uint8 RGB arrays against the contract and
    return how many values differ; raise AssertionError beyond it."""
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    n_diff = int(np.count_nonzero(diff))
    worst = int(diff.max()) if diff.size else 0
    if worst > max_abs:
        raise AssertionError(f"{what}: max |diff| {worst} > {max_abs}")
    if n_diff > diff.size * max_fraction:
        raise AssertionError(f"{what}: {n_diff}/{diff.size} values differ")
    return n_diff
