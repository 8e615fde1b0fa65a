"""jpeglibrary_tpu — a JPEG codec framework on JAX.

A from-scratch re-design of the capability matrix of
yigolden/JpegLibrary (the reference C# library) for JAX/XLA:

- decode: every T.81 Table B.1 process — baseline (SOF0/1),
  progressive (SOF2), lossless (SOF3), arithmetic (SOF9/10/11),
  hierarchical (SOF5-7/13-15); one-call fused host RGB (decode_rgb8);
  span-skipping region-of-interest decode (decode_region)
- encode: the same complete matrix (baseline std/optimized/
  package-merge, progressive, lossless, arithmetic, hierarchical,
  CMYK/YCCK, 12-bit, bufferless streaming, restart emission)
- transcode/transform: universal lossless entropy re-coding,
  jpegtran-class rotations/flips/crop/autorotate, optimizer
- batched, sharded multi-image pipelines over jax.sharding meshes

Architecture: host container parsing -> entropy decode (native C++
scanner / restart-segment parallel) -> batched device transform
programs (dequant + IDCT + upsample + color) -> output formatting.
"""

import pathlib

#: Where a GPU process keeps its compiled programs when
#: JAX_COMPILATION_CACHE_DIR is not set: a fixed path in the checkout,
#: so that every later process finds them again.
CHECKOUT_COMPILE_CACHE = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"

_COMPILE_CACHE_CHECKED = False


def enable_compile_cache() -> None:
    """Turn on JAX's persistent compilation cache for a GPU backend.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its
    cache there and this function sets nothing. Otherwise a GPU process
    caches under :data:`CHECKOUT_COMPILE_CACHE`. The CPU backend stays
    uncached: XLA:CPU caches AOT machine code whose machine-feature
    assumptions don't transfer across hosts (observed producing wrong
    numerics when loaded elsewhere).

    Called lazily from the device pipeline factories, after the backend
    is known; safe to call repeatedly."""
    global _COMPILE_CACHE_CHECKED
    if _COMPILE_CACHE_CHECKED:
        return
    _COMPILE_CACHE_CHECKED = True
    import jax

    if jax.config.jax_compilation_cache_dir is None and jax.default_backend() == "gpu":
        jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_COMPILE_CACHE))


from .models.decoder import DecodeResult, ImageInfo, JpegDecoder, decode, decode_rgb8
from .models.encoder import (
    JpegEncoder,
    encode_cmyk,
    encode_gray,
    encode_rgb,
    encode_rgb_stream,
    encode_rgb_stripes,
)
from .models.hierarchical import encode_hierarchical
from .models.lossless import encode_lossless
from .models.arithmetic_lossless import encode_lossless_arithmetic
from .models.optimizer import JpegOptimizer, optimize
from .models.region import decode_region
from .models.transcode import autorotate, crop, transcode, transform
from .parallel.batch import decode_batch_rgb, decode_stream_rgb, encode_batch_rgb

__all__ = [
    "JpegDecoder",
    "DecodeResult",
    "ImageInfo",
    "decode",
    "decode_rgb8",
    "decode_batch_rgb",
    "decode_region",
    "decode_stream_rgb",
    "JpegEncoder",
    "encode_batch_rgb",
    "encode_rgb",
    "encode_rgb_stream",
    "encode_rgb_stripes",
    "encode_gray",
    "encode_cmyk",
    "encode_lossless",
    "encode_lossless_arithmetic",
    "encode_hierarchical",
    "JpegOptimizer",
    "optimize",
    "autorotate",
    "crop",
    "transcode",
    "transform",
    "enable_compile_cache",
]

__version__ = "0.1.0"
