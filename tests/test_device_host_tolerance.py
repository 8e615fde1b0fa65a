"""Device-transform vs host-transform tolerance contract.

The HOST path (``to_rgb8`` / ``to_uint16_extended``, xp=numpy) is the
bit-exact golden path: it keeps the reference's float32 AAN operation
order and reproduces the C# reference's committed fixtures bit-for-bit
(tests/test_golden_fixtures.py).

The DEVICE path (``to_rgb8_device`` and the batched/stacked pipelines)
runs the same arithmetic as one jitted XLA program. XLA's codegen for a
given shape may shift the float32 IDCT output by 1 ULP relative to
numpy (FMA contraction / vectorization order), and
``decode_stage.dequantize_idct_shift`` rounds with rint — so a sample
whose true IDCT value sits exactly on a .5 razor edge can round the
other way, by 1 sample LSB (up to 2 RGB levels after the chroma
matrix). The contract is jpeglibrary_tpu.utils.tolerance.

Within one compiled program the output is deterministic. Two different
programs (the single-image and the stacked batch transform) are each
held to the same contract; exact equality between them is not
promised, because each program's codegen may contract differently.
"""

import numpy as np
import pytest

import jpeglibrary_tpu as jt
from jpeglibrary_tpu.models.decoder import JpegDecoder
from jpeglibrary_tpu.utils.tolerance import rgb_mismatch


@pytest.fixture(scope="module")
def photo_blob(photo_jpegs):
    return photo_jpegs[0]


def _decode(blob, **kw):
    dec = JpegDecoder()
    dec.set_input(blob)
    return dec.decode(**kw)


def test_device_transform_within_one_sample_lsb(photo_blob):
    res = _decode(photo_blob, sparse_direct=True)
    host = res.to_rgb8()
    dev = np.moveaxis(np.asarray(res.to_rgb8_device(sparse=True)), 0, -1)
    # Razor-edge rint ties only: tiny count, bounded magnitude. A real
    # transform bug moves 8x8 blocks by many levels and trips both.
    rgb_mismatch(dev, host, "device vs host")


def test_batched_program_matches_single_device_program(photo_blob):
    """The stacked (vmapped) transform and the single-image device
    transform are two XLA programs over the same ops; grouping must not
    change values beyond the rounding-tie contract."""
    from jpeglibrary_tpu.parallel.batch import decode_batch_rgb

    res = _decode(photo_blob, sparse_direct=True)
    dev = np.moveaxis(np.asarray(res.to_rgb8_device(sparse=True)), 0, -1)
    batch = np.asarray(decode_batch_rgb([photo_blob])[0])
    rgb_mismatch(batch, dev, "batched vs single program")


def test_device_program_is_deterministic(photo_blob):
    res = _decode(photo_blob, sparse_direct=True)
    a = np.asarray(res.to_rgb8_device(sparse=True))
    b = np.asarray(res.to_rgb8_device(sparse=True))
    np.testing.assert_array_equal(a, b)


def test_host_golden_path_unaffected(assets_dir):
    """The golden-parity path stays bit-exact vs the reference's
    committed fixture (the tolerance above is device-path-only)."""
    from jpeglibrary_tpu.utils.fixtures import load_expected_buffer

    lake = assets_dir / "baseline/lake.jpg"
    res = jt.decode(lake.read_bytes())
    exp = load_expected_buffer(str(lake), 3)[..., :3]
    assert (res.to_uint16_extended() == exp).all()
