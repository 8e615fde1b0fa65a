"""Scaled decode (libjpeg-class DCT-domain 1/2, 1/4, 1/8 downscaling).

to_rgb8_scaled(s) inverse-transforms only the 8*s lowest frequencies
per axis straight to the scaled block (spectral truncation — block
means exact, so a flat image decodes exactly at every scale), without
materializing the full-resolution planes. Validated against the
area-averaged full decode and PIL's libjpeg draft mode.
"""

import io

import numpy as np
import pytest
from PIL import Image

import jpeglibrary_tpu as jt


def _area_down(img, f):
    h, w = img.shape[:2]
    hh, ww = h // f * f, w // f * f
    return img[:hh, :ww].reshape(hh // f, f, ww // f, f, 3).mean(axis=(1, 3))


def _image(h, w, seed=2):
    rng = np.random.default_rng(seed)
    base = np.linspace(0, 255, w)[None, :, None] + np.linspace(0, 90, h)[:, None, None]
    return np.clip(base + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("scale,f", [(0.5, 2), (0.25, 4), (0.125, 8)])
@pytest.mark.parametrize("subsampling", ["420", "444"])
def test_scaled_matches_area_average(scale, f, subsampling):
    rgb = _image(160, 224)
    res = jt.decode(jt.encode_rgb(rgb, 85, subsampling=subsampling))
    full = np.asarray(res.to_rgb8()).astype(np.float64)
    s = np.asarray(res.to_rgb8_scaled(scale))
    assert s.shape[0] == -(-res.height * int(8 * scale) // 8)
    assert s.shape[1] == -(-res.width * int(8 * scale) // 8)
    ref = _area_down(full, f)
    a = s[: ref.shape[0], : ref.shape[1]].astype(np.float64)
    psnr = 10 * np.log10(255**2 / ((a - ref) ** 2).mean())
    assert psnr > 28, psnr


def test_scaled_flat_image_exact():
    rgb = np.full((64, 96, 3), 180, dtype=np.uint8)
    res = jt.decode(jt.encode_rgb(rgb, 90, subsampling="444"))
    full = np.asarray(res.to_rgb8())
    for scale, f in ((0.5, 2), (0.25, 4), (0.125, 8)):
        s = np.asarray(res.to_rgb8_scaled(scale))
        np.testing.assert_array_equal(s, full[::f, ::f])


def test_scaled_vs_pil_draft(assets_dir):
    data = (assets_dir / "baseline/lake.jpg").read_bytes()
    res = jt.decode(data)
    ours = np.asarray(res.to_rgb8_scaled(0.125)).astype(np.float64)
    im = Image.open(io.BytesIO(data))
    im.draft("RGB", (im.width // 8, im.height // 8))
    pil = np.asarray(im.convert("RGB")).astype(np.float64)
    assert pil.shape == ours.shape
    psnr = 10 * np.log10(255**2 / ((pil - ours) ** 2).mean())
    assert psnr > 30, psnr


def test_scaled_odd_dimensions_and_gray():
    from jpeglibrary_tpu.models.encoder import encode_gray

    g = _image(53, 41)[..., 0]
    res = jt.decode(encode_gray(g, 85))
    s = np.asarray(res.to_rgb8_scaled(0.25))
    assert s.shape == (-(-53 * 2 // 8), -(-41 * 2 // 8), 3)
    # grayscale: all three channels equal
    assert (s[..., 0] == s[..., 1]).all() and (s[..., 1] == s[..., 2]).all()


def test_scaled_progressive_and_errors():
    rgb = _image(64, 64, seed=5)
    from jpeglibrary_tpu.models.progressive_encoder import encode_progressive_rgb

    res = jt.decode(encode_progressive_rgb(rgb, 85))
    s = np.asarray(res.to_rgb8_scaled(0.5))
    assert s.shape == (32, 32, 3)
    with pytest.raises(ValueError, match="scale"):
        res.to_rgb8_scaled(0.3)
    from jpeglibrary_tpu.models.lossless import encode_lossless

    res_ll = jt.decode(encode_lossless(rgb, predictor=1))
    with pytest.raises(ValueError, match="lossless"):
        res_ll.to_rgb8_scaled(0.5)


def test_scaled_device_paths_match_host():
    """The device pipeline (sparse payload + reduced-IDCT program) must
    agree with the host to_rgb8_scaled for every scale and path."""
    rgb = _image(80, 112, seed=7)
    data = jt.encode_rgb(rgb, 85)
    for scale in (0.5, 0.25, 0.125):
        res = jt.decode(data, sparse_direct=True)
        host = np.asarray(jt.decode(data).to_rgb8_scaled(scale))
        dev = np.moveaxis(np.asarray(res.to_rgb8_device(scale=scale)), 0, -1)
        # host numpy and device XLA order the reduced-IDCT float ops
        # differently -> occasional ±1 at rint boundaries, up to ±2
        # after the fixed-point color conversion
        diff = np.abs(dev.astype(int) - host.astype(int))
        assert diff.max() <= 2 and (diff > 0).mean() < 0.05
        # the batch and stream paths run the same device program ->
        # exact agreement with the single-image device path
        batch = jt.decode_batch_rgb([data, data], scale=scale)
        np.testing.assert_array_equal(batch[0], dev)
        np.testing.assert_array_equal(batch[1], dev)
        outs = list(jt.decode_stream_rgb([data], scale=scale))
        np.testing.assert_array_equal(np.moveaxis(np.asarray(outs[0]), 0, -1), dev)
