"""Multi-device sharding tests on the virtual 8-device CPU mesh.

The project test strategy (SURVEY.md §4.5): assert bit-exact equality of
sharded vs single-device execution — the distributed analogue of the
reference's golden-file discipline.
"""

import numpy as np
import pytest

import jax


def _example(batch=4, hb=8, wb=16):
    rng = np.random.default_rng(7)
    y = rng.integers(-128, 128, size=(batch, hb, wb, 64), dtype=np.int16)
    cb = rng.integers(-64, 64, size=(batch, hb // 2, wb // 2, 64), dtype=np.int16)
    cr = rng.integers(-64, 64, size=(batch, hb // 2, wb // 2, 64), dtype=np.int16)
    from jpeglibrary_tpu.syntax.quantization import (
        STANDARD_CHROMINANCE_ZIGZAG,
        STANDARD_LUMINANCE_ZIGZAG,
    )

    return (
        y, cb, cr,
        STANDARD_LUMINANCE_ZIGZAG.astype(np.int32),
        STANDARD_CHROMINANCE_ZIGZAG.astype(np.int32),
    )


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("n_devices,stripe", [(8, 2), (4, 1), (2, 2)])
def test_sharded_full_step_matches_single_device(n_devices, stripe):
    from jpeglibrary_tpu.parallel.sharding import (
        full_step,
        make_mesh,
        make_sharded_full_step,
    )

    args = _example()
    ref = jax.jit(full_step)(*args)

    mesh = make_mesh(n_devices, stripe=stripe)
    out = make_sharded_full_step(mesh)(*args)

    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_graft_entry_and_dryrun():
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import __graft_entry__ as ge

    fn, example = ge.entry()
    out = jax.jit(fn)(*example)
    jax.block_until_ready(out)
    ge.dryrun_multichip(8)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("rel", ["baseline/lake.jpg", "baseline/cramps.jpg"])
def test_stripe_sharded_single_image_decode(assets_dir, rel):
    """SP/CP for the decode path: ONE image's transform sharded over
    the mesh stripe axis (per-stripe payload slices, zero halo) must be
    bit-exact vs the single-device transform."""
    from jpeglibrary_tpu.models.decoder import JpegDecoder
    from jpeglibrary_tpu.parallel.sharding import (
        assemble_stripes,
        decode_rgb_sharded,
        make_mesh,
    )

    data = (assets_dir / rel).read_bytes()
    mesh = make_mesh(8, stripe=4)
    out, heights = decode_rgb_sharded(data, mesh)
    img = assemble_stripes(out, heights)
    d = JpegDecoder()
    d.set_input(data)
    ref = np.asarray(d.decode(sparse_direct=True).to_rgb8_device())
    np.testing.assert_array_equal(img, ref)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize(
    "rel",
    [
        "huffman_progressive/progress.jpg",
        "huffman_progressive/yellowcat_progressive_restart.jpg",
        "arithmetic_sequential/zackthecat_arith.jpg",
        "huffman_lossless/lossless1_s22.jpg",
        "huffman_lossless/lossless2_s22.jpg",
    ],
)
def test_stripe_sharded_decode_all_modes(assets_dir, rel):
    """decode_rgb_sharded accepts every mode (VERDICT r2 #7): the dense
    coefficient planes (progressive/arithmetic) and the lossless sample
    planes shard over the stripe axis; output must be bit-exact vs the
    single-device host to_rgb8 path."""
    import jpeglibrary_tpu as jt
    from jpeglibrary_tpu.parallel.sharding import (
        assemble_stripes,
        decode_rgb_sharded,
        make_mesh,
    )

    data = (assets_dir / rel).read_bytes()
    mesh = make_mesh(8, stripe=4)
    out, heights = decode_rgb_sharded(data, mesh)
    img = assemble_stripes(out, heights)  # planar [3, H, W]
    ref = np.moveaxis(jt.decode(data).to_rgb8(), -1, 0)
    if "lossless" in rel:
        # integer-only transform (no DCT floats): exact everywhere
        np.testing.assert_array_equal(img, ref)
    else:
        # XLA FMA-contracts the float IDCT differently per compiled
        # shape, flipping 1 LSB on rare pixels vs the numpy host path.
        img = img.astype(np.int64)
        d = np.abs(img - ref.astype(np.int64))
        assert d.max() <= 1 and (d > 0).mean() < 1e-4, (d.max(), (d > 0).mean())


def test_batched_transform_rgb_matches_loop(assets_dir):
    import jpeglibrary_tpu as jt
    from jpeglibrary_tpu.parallel.sharding import batched_transform_rgb, make_mesh

    data = (assets_dir / "baseline/lake.jpg").read_bytes()
    r = jt.decode(data)
    coeffs = [
        tuple(r.coefficients[c.component_index] for c in r.geometry.components)
    ] * 4
    quants = tuple(
        r.quant[c.component_index].astype(np.int32) for c in r.geometry.components
    )
    mesh = make_mesh(4, stripe=1)
    batch = batched_transform_rgb(coeffs, quants, r.geometry, mesh=mesh)
    single = r.to_rgb8()
    for i in range(4):
        np.testing.assert_array_equal(np.asarray(batch[i]), single)


def test_batch_mixed_quality_same_geometry():
    """Same-geometry images with DIFFERENT quant tables must each
    dequantize with their own tables — grouping is by geometry, so the
    quants ride the vmap alongside the payloads."""
    import jpeglibrary_tpu as jt
    from jpeglibrary_tpu.parallel.batch import decode_batch_rgb, decode_stream_rgb

    rng = np.random.default_rng(5)
    img = np.clip(
        np.linspace(0, 255, 96)[None, :, None] + rng.normal(0, 18, (80, 96, 3)),
        0, 255,
    ).astype(np.uint8)
    q90 = jt.encode_rgb(img, 90)
    q25 = jt.encode_rgb(img, 25)
    singles = [jt.decode(q90).to_rgb8(), jt.decode(q25).to_rgb8()]
    outs = decode_batch_rgb([q90, q25])
    for got, expect in zip(outs, singles):
        np.testing.assert_array_equal(np.asarray(got), expect)
    # grouped streaming path too
    stream = [
        np.moveaxis(np.asarray(o), 0, -1)
        for o in decode_stream_rgb([q90, q25, q90, q25], group=4)
    ]
    for got, expect in zip(stream, singles * 2):
        np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_stream_depth_preserves_order(depth):
    """The in-flight bound (default 4 since round 5 — measured to
    absorb sync-point stalls) must never affect output values or
    order, at any depth, including depth > len(batch)."""
    import jpeglibrary_tpu as jt
    from jpeglibrary_tpu.parallel.batch import decode_stream_rgb

    rng = np.random.default_rng(11)
    imgs = [
        np.clip(
            np.linspace(0, 255, 96)[None, :, None]
            + rng.normal(0, 10 + 4 * i, (80, 96, 3)),
            0, 255,
        ).astype(np.uint8)
        for i in range(3)
    ]
    datas = [jt.encode_rgb(im, q) for im, q in zip(imgs, (90, 50, 25))]
    singles = [jt.decode(d).to_rgb8() for d in datas]
    outs = [
        np.moveaxis(np.asarray(o), 0, -1)
        for o in decode_stream_rgb(datas * 2, depth=depth, scan_workers=2,
                                   device_workers=2)
    ]
    assert len(outs) == 6
    for got, expect in zip(outs, singles * 2):
        np.testing.assert_array_equal(got, expect)


def test_batch_rgb_coded_stream_uses_host_colors():
    """RGB-coded baseline JPEGs (Adobe transform 0 / R,G,B component
    ids) must NOT ride the stacked YCbCr device transform: the batch
    API falls back to the host writer (round-5 review finding — the
    grouped v2 branch silently mis-colored them)."""
    import jpeglibrary_tpu as jt
    from jpeglibrary_tpu.models.encoder import JpegEncoder
    from jpeglibrary_tpu.parallel.batch import decode_batch_rgb, decode_stream_rgb
    from jpeglibrary_tpu.syntax import huffman_standard
    from jpeglibrary_tpu.syntax.quantization import (
        scale_by_quality,
        standard_luminance_table,
    )

    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    enc = JpegEncoder()
    enc.set_quantization_table(scale_by_quality(standard_luminance_table(0), 95))
    enc.set_huffman_table(True, 0, huffman_standard.dc_luminance())
    enc.set_huffman_table(False, 0, huffman_standard.ac_luminance())
    for i, cid in enumerate((0x52, 0x47, 0x42)):  # 'R','G','B' ids
        enc.add_component(cid, 0, 0, 0, 1, 1)
    enc.set_input([img[..., i] for i in range(3)])
    data = enc.encode()
    res = jt.decode(data)
    assert res.color_transform == "rgb"
    expect = res.to_rgb8()

    outs = decode_batch_rgb([data, data])
    for o in outs:
        np.testing.assert_array_equal(np.asarray(o), expect)

    # the streaming pipeline's per-image contract is to raise (same as
    # to_rgb8_device); the grouped branch must not silently bypass it
    with pytest.raises(ValueError):
        list(decode_stream_rgb([data, data], group=2))


def test_batch_mixed_ac_density_rides_stacked_v2():
    """Same-geometry images with different AC densities (different
    payload bucket sizes) must still batch into ONE stacked v2 call via
    re-bucketing, not fall to the dense host re-pack path."""
    import jpeglibrary_tpu as jt
    from jpeglibrary_tpu.parallel.batch import (
        _stack_payloads2,
        decode_batch_rgb,
        scan_images,
    )

    rng = np.random.default_rng(9)
    flat = np.full((64, 64, 3), 128, dtype=np.uint8)
    noisy = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    datas = [jt.encode_rgb(flat, 95), jt.encode_rgb(noisy, 95)]
    results = scan_images(datas)
    if any(r.packed_mcu2 is None for r in results):
        pytest.skip("v2 wire unavailable (no native scanner)")
    assert results[0].packed_mcu2.shape != results[1].packed_mcu2.shape
    stacked = _stack_payloads2(results, results[0].geometry)
    assert stacked is not None and stacked.shape[0] == 2

    singles = [jt.decode(d).to_rgb8() for d in datas]
    outs = decode_batch_rgb(datas)
    for got, expect in zip(outs, singles):
        np.testing.assert_array_equal(np.asarray(got), expect)
