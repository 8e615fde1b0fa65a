"""Jitted end-to-end device transform pipelines.

The device replacement for the reference's per-block output pipeline
(JpegHuffmanBaselineScanDecoder.cs:99-137 block loop + the app-side
writers/converters): one XLA program takes all components' coefficient
planes and produces the final interleaved image, fusing dequantize,
un-zigzag, IDCT, level shift, duplication upsample, crop, clamp and
color conversion.

Compiled programs are cached per frame geometry (static shapes).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from ..models.geometry import FrameGeometry
from . import color as color_ops
from . import decode_stage


def _block_transform(xp):
    """Dequantize + IDCT + level shift of [..., 64] zig-zag blocks for a
    program in ``xp``: the Triton kernel (ops.idct_kernel) on a GPU
    backend, where it was measured faster than XLA's fusion of the
    butterfly, and the reference butterfly everywhere else."""
    if xp is not np:
        import jax

        if jax.default_backend() == "gpu":
            from . import idct_kernel

            return idct_kernel.dequantize_idct_shift
    return functools.partial(decode_stage.dequantize_idct_shift, xp=xp)


def _transform_planes(coeffs: Tuple, quants: Tuple, geometry: FrameGeometry, xp):
    """Per-component: zig-zag coeffs [Hb,Wb,64] -> cropped int32 plane [H,W]."""
    idct = _block_transform(xp)
    planes = []
    for cg, cz, qz in zip(geometry.components, coeffs, quants):
        plane = decode_stage.blocks_to_plane(idct(cz, qz, geometry.level_shift), xp=xp)
        plane = decode_stage.upsample_duplicate(plane, cg.hs, cg.vs, xp=xp)
        planes.append(plane[: geometry.height, : geometry.width])
    return tuple(planes)


def transform_to_rgb8(coeffs: Tuple, quants: Tuple, geometry: FrameGeometry, xp=np,
                      *, layout: str = "hwc", upsample: str = "duplicate",
                      scale_n: int = 8):
    """Coefficient planes -> uint8 RGB ([H, W, 3] or planar [3, H, W]).

    Matches the reference JpegDecode app output path: 8-bit clamp writer
    (JpegBufferOutputWriter8Bit.cs:28-60) then the fixed-point YCbCr->RGB
    converter; grayscale images replicate Y with Cb=Cr=128
    (DecodeAction.cs:58-66).

    ``layout="chw"`` keeps channels as the major axis: the planar
    [3, H, W] form is the device output of every serving entry point
    (``DecodeResult.to_rgb8_device``), so a consumer that works per
    channel reads contiguous planes. Whether the interleaved form would
    be cheaper on the GPU is not measured.
    """
    if scale_n != 8:
        # Scaled decode (1/2, 1/4, 1/8): the reduced IDCT maps each
        # block straight to scale_n x scale_n pixels
        # (decode_stage.scaled_idct_matrix) — at 1/8 the per-block
        # work is one multiply of the DC plane.
        if upsample == "fancy":
            raise ValueError("fancy upsampling is full-resolution only")
        out_h = -(-geometry.height * scale_n // 8)
        out_w = -(-geometry.width * scale_n // 8)
        u8 = [
            decode_stage.normalize_to_uint8(
                decode_stage.component_plane_scaled(
                    cz, qz, geometry.level_shift, cg.hs, cg.vs,
                    out_h, out_w, scale_n, xp=xp,
                ),
                geometry.precision, xp=xp,
            )
            for cg, cz, qz in zip(geometry.components, coeffs, quants)
        ]
    elif upsample == "fancy":
        # libjpeg's default triangular filter, applied to the clamped
        # writer output at component resolution (decode_stage.
        # upsample_fancy) — pure adds/shifts, XLA fuses it into the
        # same program.
        u8 = []
        for cg, cz, qz in zip(geometry.components, coeffs, quants):
            hc = -(-geometry.height // cg.vs)
            wc = -(-geometry.width // cg.hs)
            plane = decode_stage.component_plane(
                cz, qz, geometry.level_shift, 1, 1, hc, wc, xp=xp
            )
            p8 = decode_stage.normalize_to_uint8(plane, geometry.precision, xp=xp)
            p8 = decode_stage.upsample_fancy(p8, cg.hs, cg.vs, xp=xp)
            u8.append(p8[: geometry.height, : geometry.width].astype(xp.uint8))
    else:
        planes = _transform_planes(coeffs, quants, geometry, xp)
        u8 = [
            decode_stage.normalize_to_uint8(p, geometry.precision, xp=xp) for p in planes
        ]
    if len(u8) == 1:
        y = u8[0]
        half = xp.full_like(y, 128)
        r, g, b = color_ops.ycbcr_to_rgb(y, half, half, xp=xp)
    elif len(u8) == 3:
        r, g, b = color_ops.ycbcr_to_rgb(u8[0], u8[1], u8[2], xp=xp)
    else:
        raise ValueError(f"RGB output needs 1 or 3 components, got {len(u8)}.")
    axis = -1 if layout == "hwc" else 0
    return xp.stack([r, g, b], axis=axis)


def transform_to_u16(coeffs: Tuple, quants: Tuple, geometry: FrameGeometry, xp=np):
    """Coefficient planes -> [H, W, C] uint16 (extending-writer semantics,
    the golden-fixture format)."""
    planes = _transform_planes(coeffs, quants, geometry, xp)
    ext = [decode_stage.extend_to_uint16(p, geometry.precision, xp=xp) for p in planes]
    return xp.stack(ext, axis=-1)


def pack_sparse(coefficients, geometry: FrameGeometry, *, bucket_factor: float = 1.5) -> np.ndarray:
    """All components' nonzero coefficients packed into ONE FLAT int32
    buffer of interleaved (global flat index, value) pairs — a single
    host->device transfer per image. Bucketed zero padding keeps shapes
    stable (scatter-ADD of 0 at index 0 is a no-op)."""
    idx_parts = []
    val_parts = []
    base = 0
    for cg in geometry.components:
        flat = coefficients[cg.component_index].reshape(-1)
        idx = np.flatnonzero(flat)
        idx_parts.append(idx + base)
        val_parts.append(flat[idx])
        base += flat.shape[0]
    idx_all = np.concatenate(idx_parts)
    val_all = np.concatenate(val_parts)
    n = len(idx_all)
    bucket = 1024
    while bucket < n:
        bucket = (int(bucket * bucket_factor) + 1023) & ~1023
    packed = np.zeros((bucket, 2), dtype=np.int32)
    packed[:n, 0] = idx_all
    packed[:n, 1] = val_all
    return packed.reshape(-1)


@functools.lru_cache(maxsize=64)
def jitted_transform_delta(geometry: FrameGeometry, output: str = "rgb8", upsample: str = "duplicate",
                           scale_n: int = 8):
    """Compiled transform taking the native 4-byte sparse wire format:
    a FLAT int16 [2n] buffer of interleaved (delta uint16, value int16)
    entries in concatenated-plane flat order (native
    scanner.pack_sparse), one transfer per image.
    Reconstruction is a cumsum over the deltas + one scatter-add;
    escape entries (delta 0xFFFF, value 0) and (0, 0) padding add zero.
    Output is planar CHW (see transform_to_rgb8).
    """
    from .. import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    shapes = [
        (c.blocks_per_column, c.blocks_per_line, 64) for c in geometry.components
    ]
    sizes = [s[0] * s[1] * s[2] for s in shapes]
    total = sum(sizes)

    def fn(packed_flat, quants_stacked):
        packed = packed_flat.reshape(-1, 2)
        deltas = packed[:, 0].astype(jnp.int32) & 0xFFFF  # uint16 bits
        vals = packed[:, 1].astype(jnp.int32)
        pos = jnp.cumsum(deltas) - 1  # the packer starts from index -1
        dense = jnp.zeros((total,), dtype=jnp.int32).at[pos].add(vals)
        coeffs = []
        off = 0
        for shape, size in zip(shapes, sizes):
            coeffs.append(jax.lax.dynamic_slice_in_dim(dense, off, size).reshape(shape))
            off += size
        quants = tuple(quants_stacked[i] for i in range(len(shapes)))
        if output == "rgb8":
            return transform_to_rgb8(tuple(coeffs), quants, geometry, xp=jnp,
                                     layout="chw", upsample=upsample,
                                     scale_n=scale_n)
        return transform_to_u16(tuple(coeffs), quants, geometry, xp=jnp)

    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def jitted_transform_mcu_inner(geometry: FrameGeometry, output: str = "rgb8", upsample: str = "duplicate",
                               scale_n: int = 8):
    """Un-jitted transform for the MCU-interleaved sparse wire format
    produced by the merged native decode+pack
    (native.scanner.decode_baseline_scan_sparse): a FLAT int16 [2n]
    buffer of (delta uint16, value int16) entries whose positions run in
    entropy-decode order — MCU m owns [m*cpm, (m+1)*cpm) with each
    component's h*v blocks consecutive inside the MCU. The un-interleave
    to per-component [Hb, Wb, 64] planes is a reshape+transpose, which
    XLA folds into layout assignment (no gather). Output is planar CHW.

    Returned un-jitted so callers can vmap it (parallel.batch groups
    same-shape images into one stacked dispatch); use
    jitted_transform_mcu for the single-image compiled form.
    """
    from .. import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    mr = geometry.mcus_per_column
    mc = geometry.mcus_per_line
    comps = geometry.components
    cpm = 64 * sum(c.h * c.v for c in comps)
    total = mr * mc * cpm

    def fn(packed_flat, quants_stacked):
        packed = packed_flat.reshape(-1, 2)
        deltas = packed[:, 0].astype(jnp.int32) & 0xFFFF  # uint16 bits
        vals = packed[:, 1].astype(jnp.int32)
        pos = jnp.cumsum(deltas) - 1  # emitter starts from position -1
        dense = jnp.zeros((total,), dtype=jnp.int32).at[pos].add(vals)
        per_mcu = dense.reshape(mr * mc, cpm)
        coeffs = []
        off = 0
        for c in comps:
            size = c.h * c.v * 64
            blk = jax.lax.slice_in_dim(per_mcu, off, off + size, axis=1)
            blk = (
                blk.reshape(mr, mc, c.v, c.h, 64)
                .transpose(0, 2, 1, 3, 4)
                .reshape(mr * c.v, mc * c.h, 64)
            )
            coeffs.append(blk)
            off += size
        quants = tuple(quants_stacked[i] for i in range(len(comps)))
        if output == "rgb8":
            return transform_to_rgb8(tuple(coeffs), quants, geometry, xp=jnp,
                                     layout="chw", upsample=upsample,
                                     scale_n=scale_n)
        return transform_to_u16(tuple(coeffs), quants, geometry, xp=jnp)

    return fn


@functools.lru_cache(maxsize=64)
def jitted_transform_mcu2_inner(geometry: FrameGeometry, output: str = "rgb8",
                                upsample: str = "duplicate", scale_n: int = 8):
    """Un-jitted transform for the v2 split-stream wire format
    (native.scanner.decode_image_sparse2): one flat uint8 buffer
    ``[dc int16*NB][counts u8*NB][acpos u8*Bn][acval i8*Bn][exc i32*2*Be]``
    at ~0.4-0.6x the v1 bytes. NB is a geometry constant; Bn/Be are
    recovered from the (static) payload length (Be = Bn/64, so
    K = 3*NB + 17*Bn/8). Densification: AC entries expand to absolute
    positions via a cumsum/searchsorted segment expansion over the
    per-block counts, scatter-add onto the dense grid, the rare
    |AC| > 127 residuals scatter-add on top, and the dense DC plane
    lands in column 0 — all fusable elementwise/scatter work ahead of
    the same reshape + batched-IDCT pipeline as v1. Also the builder
    of the batched and sharded v2 programs, so it turns on the
    compile cache for them."""
    from .. import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    mr = geometry.mcus_per_column
    mc = geometry.mcus_per_line
    comps = geometry.components
    bpm = sum(c.h * c.v for c in comps)
    cpm = 64 * bpm
    nb = mr * mc * bpm

    def fn(payload_u8, quants_stacked):
        k = payload_u8.shape[0]
        bn = (k - 3 * nb) * 8 // 17
        be = bn // 64
        dc = jax.lax.bitcast_convert_type(
            payload_u8[: 2 * nb].reshape(nb, 2), jnp.int16
        ).astype(jnp.int32)
        counts = payload_u8[2 * nb : 3 * nb].astype(jnp.int32)
        acpos = payload_u8[3 * nb : 3 * nb + bn].astype(jnp.int32)
        acval = jax.lax.bitcast_convert_type(
            payload_u8[3 * nb + bn : 3 * nb + 2 * bn], jnp.int8
        ).astype(jnp.int32)
        exc = jax.lax.bitcast_convert_type(
            payload_u8[3 * nb + 2 * bn :].reshape(be, 2, 4), jnp.int32
        )
        # Segment expansion: scatter a marker at each block's first
        # entry slot (exclusive cumsum of counts; zero-count blocks
        # stack markers on the next block's slot) and prefix-sum — an
        # O(Bn) alternative to a binary search per entry. Markers of
        # blocks starting at/after the real-entry tail drop out of
        # bounds, so bucket-padding entries inherit the last real
        # block's id with (pos 0, val 0): a scatter-add of 0.
        ends = jnp.cumsum(counts)
        starts = ends - counts
        seg = jnp.zeros((bn,), dtype=jnp.int32).at[starts].add(1)
        block_id = jnp.cumsum(seg) - 1
        block_id = jnp.clip(block_id, 0, nb - 1)
        pos = block_id * 64 + acpos
        dense = jnp.zeros((nb * 64,), dtype=jnp.int32).at[pos].add(acval)
        dense = dense.at[exc[:, 0]].add(exc[:, 1])
        dense = dense.reshape(nb, 64).at[:, 0].add(dc)
        per_mcu = dense.reshape(mr * mc, cpm)
        coeffs = []
        off = 0
        for c in comps:
            size = c.h * c.v * 64
            blk = jax.lax.slice_in_dim(per_mcu, off, off + size, axis=1)
            blk = (
                blk.reshape(mr, mc, c.v, c.h, 64)
                .transpose(0, 2, 1, 3, 4)
                .reshape(mr * c.v, mc * c.h, 64)
            )
            coeffs.append(blk)
            off += size
        quants = tuple(quants_stacked[i] for i in range(len(comps)))
        if output == "rgb8":
            return transform_to_rgb8(tuple(coeffs), quants, geometry, xp=jnp,
                                     layout="chw", upsample=upsample,
                                     scale_n=scale_n)
        return transform_to_u16(tuple(coeffs), quants, geometry, xp=jnp)

    return fn


@functools.lru_cache(maxsize=64)
def jitted_transform_mcu2(geometry: FrameGeometry, output: str = "rgb8",
                          upsample: str = "duplicate", scale_n: int = 8):
    """Compiled single-image form of jitted_transform_mcu2_inner."""
    import jax

    return jax.jit(jitted_transform_mcu2_inner(geometry, output, upsample, scale_n))


@functools.lru_cache(maxsize=64)
def jitted_transform_mcu(geometry: FrameGeometry, output: str = "rgb8", upsample: str = "duplicate",
                         scale_n: int = 8):
    """Compiled single-image form of jitted_transform_mcu_inner."""
    import jax

    return jax.jit(jitted_transform_mcu_inner(geometry, output, upsample, scale_n))


@functools.lru_cache(maxsize=64)
def jitted_transform_packed(geometry: FrameGeometry, output: str = "rgb8", upsample: str = "duplicate"):
    """Compiled transform taking the flat packed sparse buffer (numpy
    fallback wire format); densification is a device scatter-add.
    jax.jit re-specializes per bucket size."""
    from .. import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    shapes = [
        (c.blocks_per_column, c.blocks_per_line, 64) for c in geometry.components
    ]
    sizes = [s[0] * s[1] * s[2] for s in shapes]
    total = sum(sizes)

    def fn(packed_flat, quants_stacked):
        packed = packed_flat.reshape(-1, 2)
        dense = jnp.zeros((total,), dtype=jnp.int32).at[packed[:, 0]].add(packed[:, 1])
        coeffs = []
        off = 0
        for shape, size in zip(shapes, sizes):
            coeffs.append(jax.lax.dynamic_slice_in_dim(dense, off, size).reshape(shape))
            off += size
        quants = tuple(quants_stacked[i] for i in range(len(shapes)))
        if output == "rgb8":
            return transform_to_rgb8(tuple(coeffs), quants, geometry, xp=jnp,
                                     layout="chw", upsample=upsample)
        return transform_to_u16(tuple(coeffs), quants, geometry, xp=jnp)

    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def jitted_transform(geometry: FrameGeometry, output: str = "rgb8", upsample: str = "duplicate"):
    """Compile (and cache) the transform for one frame geometry.

    Returns a jitted callable(coeffs_tuple, quants_tuple) -> device
    array. ``output="rgb8p"`` produces planar [3, H, W] (the layout of
    ``to_rgb8_device``); "rgb8" produces interleaved [H, W, 3].
    """
    from .. import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    if output == "rgb8":
        fn = lambda c, q: transform_to_rgb8(c, q, geometry, xp=jnp, upsample=upsample)
    elif output == "rgb8p":
        fn = lambda c, q: transform_to_rgb8(
            c, q, geometry, xp=jnp, layout="chw", upsample=upsample
        )
    elif output == "u16":
        fn = lambda c, q: transform_to_u16(c, q, geometry, xp=jnp)
    else:
        raise ValueError(f"unknown output format {output!r}")
    return jax.jit(fn)
