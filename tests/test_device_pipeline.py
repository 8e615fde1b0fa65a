"""Device serving path on seeded synthetic photos: the sparse wire
formats, the streaming and batched decoders and batch encode, each
against the host golden path under the device-vs-host contract
(jpeglibrary_tpu.utils.tolerance)."""

import numpy as np
import pytest

import jpeglibrary_tpu as jt
from jpeglibrary_tpu.utils.tolerance import rgb_mismatch


def test_device_sparse_paths_match_dense(photo_jpegs):
    """Both sparse wire formats (native delta-packed and numpy
    index-packed) reproduce the dense transform."""
    from jpeglibrary_tpu.ops.pipeline import jitted_transform_packed, pack_sparse

    r = jt.decode(photo_jpegs[0])
    dense_chw = np.moveaxis(r.to_rgb8(), -1, 0)
    # device paths yield planar CHW
    rgb_mismatch(r.to_rgb8_device(sparse=True), dense_chw, "sparse")
    rgb_mismatch(r.to_rgb8_device(sparse=False), dense_chw, "dense")
    # numpy fallback packed path
    quants = np.stack(
        [r.quant[c.component_index] for c in r.geometry.components]
    ).astype(np.int32)
    packed = pack_sparse(r.coefficients, r.geometry)
    out = jitted_transform_packed(r.geometry, "rgb8")(packed, quants)
    rgb_mismatch(out, dense_chw, "packed")


def test_native_pack_sparse_roundtrip(photo_jpegs):
    """The native 4-byte delta format reconstructs the exact planes."""
    from jpeglibrary_tpu.native import build as nbuild

    try:
        nbuild.load_library()
    except ImportError:
        pytest.skip("native library unavailable")
    from jpeglibrary_tpu.native.scanner import pack_sparse as native_pack

    r = jt.decode(photo_jpegs[0])
    planes = [r.coefficients[c.component_index] for c in r.geometry.components]
    packed = native_pack(planes)
    deltas = packed[:, 0].astype(np.int64) & 0xFFFF
    vals = packed[:, 1].astype(np.int64)
    pos = np.cumsum(deltas) - 1
    total = sum(p.size for p in planes)
    dense = np.zeros(total, dtype=np.int64)
    np.add.at(dense, pos, vals)
    expected = np.concatenate([p.reshape(-1).astype(np.int64) for p in planes])
    np.testing.assert_array_equal(dense, expected)


def test_decode_stream_rgb(photo_jpegs):
    """The pipelined streaming decoder yields in-order results that
    match the per-image host path."""
    from jpeglibrary_tpu.parallel.batch import decode_stream_rgb

    a, b = photo_jpegs
    expected = [jt.decode(d).to_rgb8() for d in (a, b, a)]
    outs = list(decode_stream_rgb([a, b, a]))
    assert len(outs) == 3
    for o, e in zip(outs, expected):
        # the stream yields planar CHW
        rgb_mismatch(np.moveaxis(np.asarray(o), 0, -1), e, "stream")


def test_batch_decode_rgb_with_mesh(photo_jpegs):
    """Sparse batch path under a data-parallel mesh matches unsharded."""
    import jax

    from jpeglibrary_tpu.parallel.batch import decode_batch_rgb
    from jpeglibrary_tpu.parallel.sharding import make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    data = photo_jpegs[0]
    single = jt.decode(data).to_rgb8()
    mesh = make_mesh(4, stripe=1)
    outs = decode_batch_rgb([data] * 4, mesh=mesh)
    for o in outs:
        rgb_mismatch(o, single, "mesh batch")


def test_encode_batch_rgb(photos):
    """Batch encode matches per-image encode byte-for-byte."""
    from jpeglibrary_tpu.parallel.batch import encode_batch_rgb

    rgb = photos[0]
    images = [rgb[:128, :128], rgb[128:256, :128], rgb[:128, 128:384]]
    batch = encode_batch_rgb(images, 75)
    for img, blob in zip(images, batch):
        assert blob == jt.encode_rgb(img, 75)


def test_batch_decode_rgb(photo_jpegs):
    """decode_batch_rgb groups same-geometry images into one stacked
    transform and matches the per-image path."""
    from jpeglibrary_tpu.parallel.batch import decode_batch_rgb

    a, b = photo_jpegs
    out = decode_batch_rgb([a, b, a])
    single_a = jt.decode(a).to_rgb8()
    single_b = jt.decode(b).to_rgb8()
    rgb_mismatch(out[0], single_a, "batch 0")
    rgb_mismatch(out[1], single_b, "batch 1")
    rgb_mismatch(out[2], single_a, "batch 2")
