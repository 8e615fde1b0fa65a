"""Seeded photographic-like test images.

Flat gradients encode to a few coefficients per block and leave most of
the decode path idle. Natural photographs have an amplitude spectrum
that falls off about as 1/f^1.2 (power 1/f^2.4), plus hard object edges.
This generator makes both from a seed, with numpy only, so that an
image's DCT coefficients are about as dense as a detailed photo's: at
q75 4:2:0 it encodes to about 1.7 bits per pixel, with about 18 nonzero
coefficients per luma block.
"""

from __future__ import annotations

import numpy as np


def _one_over_f(rng, height: int, width: int) -> np.ndarray:
    """Zero-mean, unit-variance field with a 1/f^1.2 amplitude spectrum."""
    fy = np.fft.fftfreq(height).astype(np.float32)[:, None]
    fx = np.fft.rfftfreq(width).astype(np.float32)[None, :]
    f = np.sqrt(fx * fx + fy * fy)
    f[0, 0] = 1.0
    spec = (
        rng.standard_normal(f.shape, dtype=np.float32)
        + 1j * rng.standard_normal(f.shape, dtype=np.float32)
    ) / f ** np.float32(1.2)
    spec[0, 0] = 0.0
    field = np.fft.irfft2(spec, s=(height, width)).astype(np.float32)
    return field / (field.std() + np.float32(1e-12))


def photo(height: int, width: int, seed: int = 0) -> np.ndarray:
    """uint8 [height, width, 3] RGB: a 1/f^1.2 luminance texture with
    weaker chroma textures, overlaid with flat-coloured rectangles and
    discs whose borders are hard edges."""
    rng = np.random.default_rng(seed)
    lum = _one_over_f(rng, height, width)
    cb = _one_over_f(rng, height, width)
    cr = _one_over_f(rng, height, width)
    rgb = np.empty((height, width, 3), dtype=np.float32)
    rgb[..., 0] = 40 * lum + 14 * cr
    rgb[..., 1] = 40 * lum - 6 * cb - 8 * cr
    rgb[..., 2] = 40 * lum + 18 * cb
    n_shapes = 4 + (height * width) // 65536
    for _ in range(min(n_shapes, 256)):
        colour = rng.uniform(-60, 60, 3).astype(np.float32)
        y0, x0 = int(rng.integers(0, height)), int(rng.integers(0, width))
        h = int(rng.integers(2, max(3, height // 4)))
        w = int(rng.integers(2, max(3, width // 4)))
        if rng.random() < 0.5:
            rgb[y0 : y0 + h, x0 : x0 + w] += colour
        else:
            r = max(h, w) // 2
            ys = slice(max(0, y0 - r), min(height, y0 + r + 1))
            xs = slice(max(0, x0 - r), min(width, x0 + r + 1))
            yy = np.arange(ys.start, ys.stop)[:, None] - y0
            xx = np.arange(xs.start, xs.stop)[None, :] - x0
            rgb[ys, xs] += (yy * yy + xx * xx <= r * r)[..., None] * colour
    return np.clip(rgb + 128, 0, 255).astype(np.uint8)
