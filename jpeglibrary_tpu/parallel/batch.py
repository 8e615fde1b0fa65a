"""Batched multi-image decode pipeline.

The serving-oriented decode path: many JPEGs -> host entropy scan
(threaded native scanner, restart-segment parallel) -> grouped by frame
geometry -> ONE stacked device transform per group (vmapped fused
pipeline) -> RGB batch.

This is where the per-image host/device round trips of the single-image
API amortize away; it is also the unit that shards across a mesh
(axis ``data``) for multi-chip/multi-host scaling (SURVEY.md §2.4).
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..models.decoder import DecodeResult, JpegDecoder


def scan_images(datas: Sequence[bytes], *, max_workers: Optional[int] = None) -> List[DecodeResult]:
    """Host stage: parse + entropy-decode each image (no transform;
    merged sparse fast path when eligible)."""
    def one(data: bytes) -> DecodeResult:
        dec = JpegDecoder()
        dec.set_input(data)
        return dec.decode(sparse_direct=True)

    if len(datas) == 1:
        return [one(datas[0])]
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(one, datas))


def _group_key(r: DecodeResult):
    return r.geometry


def _stacked_quants(batch, geometry) -> np.ndarray:
    """[B, n_comps, 64] int32 — each image's OWN quant tables, vmapped
    alongside its payload (grouping is by geometry only, which says
    nothing about quality)."""
    return np.stack(
        [
            np.stack(
                [r.quant[c.component_index] for c in geometry.components]
            )
            for r in batch
        ]
    ).astype(np.int32)


def _device_color_ok(r) -> bool:
    """The stacked/grouped device transforms apply the YCbCr->RGB
    matrix — the same coverage as DecodeResult.to_rgb8_device. RGB-coded
    and CMYK/YCCK streams must NOT ride them (silently mis-colored
    output otherwise)."""
    return r.color_transform in ("ycbcr", "gray")


def _stack_payloads2(batch, geometry) -> Optional[np.ndarray]:
    """Stack same-geometry v2 payloads into one [B, K] uint8 batch,
    re-bucketing to the group's largest AC bucket (zero padding in
    every stream is a device no-op) — same-geometry images routinely
    carry different AC densities, so requiring byte-identical shapes
    would send the common heterogeneous batch down the dense re-pack
    path. Returns None when any image lacks a v2 payload."""
    if not all(r.packed_mcu2 is not None for r in batch):
        return None
    from ..native import scanner as native_scanner

    bpm = sum(c.h * c.v for c in geometry.components)
    nb = geometry.mcus_per_line * geometry.mcus_per_column * bpm
    bn = max(native_scanner.v2_payload_bn(r.packed_mcu2, nb) for r in batch)
    return np.stack(
        [
            native_scanner.rebucket_v2_payload(r.packed_mcu2, nb, bn)
            for r in batch
        ]
    )


def decode_batch_rgb(
    datas: Sequence[bytes],
    *,
    mesh=None,
    max_workers: Optional[int] = None,
    scale: float = 1.0,
) -> List[np.ndarray]:
    """Decode a batch of JPEGs to RGB uint8 arrays.

    Images with identical geometry transform in one stacked jitted
    call; with a mesh, the batch dimension shards over axis ``data``.
    ``scale`` in {1, 1/2, 1/4, 1/8} runs the reduced-IDCT thumbnail
    transform on device (DCT modes; lossless images downsample on
    host).
    """
    import jax.numpy as jnp

    scale_n = int(round(8 * scale))
    if scale_n not in (1, 2, 4, 8) or abs(8 * scale - scale_n) > 1e-9:
        raise ValueError("scale must be 1, 1/2, 1/4 or 1/8")
    results = scan_images(datas, max_workers=max_workers)

    groups: Dict[object, List[int]] = {}
    for i, r in enumerate(results):
        groups.setdefault(_group_key(r), []).append(i)

    out: List[Optional[np.ndarray]] = [None] * len(results)
    for geometry, indices in groups.items():
        batch = [results[i] for i in indices]
        if batch[0].samples is not None:
            # lossless: no device transform stage; host path per image
            for i in indices:
                rgb_i = results[i].to_rgb8()
                if scale_n != 8:
                    f = 8 // scale_n
                    rgb_i = rgb_i[::f, ::f]
                out[i] = rgb_i
            continue

        # RGB-coded / CMYK / YCCK streams: the host writers know the
        # stream's color interpretation; the stacked device transforms
        # below apply the YCbCr matrix unconditionally.
        host_only = [i for i in indices if not _device_color_ok(results[i])]
        if host_only:
            for i in host_only:
                r = results[i]
                if scale_n != 8 and r.color_transform == "rgb":
                    out[i] = r.to_rgb8_scaled(scale)
                elif scale_n != 8:
                    out[i] = r.to_rgb8()[:: 8 // scale_n, :: 8 // scale_n]
                else:
                    out[i] = r.to_rgb8()
            indices = [i for i in indices if _device_color_ok(results[i])]
            if not indices:
                continue
            batch = [results[i] for i in indices]

        # Merged-scan v2 payloads: ONE stacked vmapped call (mixed AC
        # buckets re-bucket to the group max).
        stacked2 = _stack_payloads2(batch, geometry)
        if stacked2 is not None:
            quants = _stacked_quants(batch, geometry)
            rgb = np.asarray(
                _batched_mcu_transform2(geometry, scale_n, mesh)(stacked2, quants)
            )
            rgb = np.moveaxis(rgb, 1, -1)  # planar CHW -> HWC
            for j, i in enumerate(indices):
                out[i] = rgb[j]
            continue
        if (
            all(r.packed_mcu is not None for r in batch)
            and len({r.packed_mcu.shape for r in batch}) == 1
        ):
            # Per-image quant tables, vmapped alongside the payloads:
            # same-geometry images may carry different quality tables.
            quants = _stacked_quants(batch, geometry)
            stacked = np.stack([r.packed_mcu for r in batch])
            rgb = np.asarray(
                _batched_mcu_transform(geometry, scale_n, mesh)(stacked, quants)
            )
            rgb = np.moveaxis(rgb, 1, -1)  # planar CHW -> HWC
            for j, i in enumerate(indices):
                out[i] = rgb[j]
            continue

        # Ship the batch in the 4-byte sparse wire format when the
        # native packer is available: one [B, n, 2] int16 upload.
        packed_batch = None
        try:
            from ..native import scanner as native_scanner

            packs = [
                native_scanner.pack_sparse(
                    [r.coefficients[c.component_index] for c in geometry.components]
                ).reshape(-1)
                for r in batch
            ]
            width = max(p.shape[0] for p in packs)
            packed_batch = np.zeros((len(packs), width), dtype=np.int16)
            for j, p in enumerate(packs):
                packed_batch[j, : p.shape[0]] = p
        except ImportError:
            pass

        if packed_batch is not None:
            quants = _stacked_quants(batch, geometry)
            fn = _batched_transform_delta(geometry, scale_n, mesh)
            inp = packed_batch
        else:
            if scale_n != 8:
                raise RuntimeError(
                    "scaled batch decode needs the native sparse packer"
                )
            quants = tuple(
                jnp.asarray(
                    np.stack(
                        [r.quant[c.component_index] for r in batch]
                    ).astype(np.int32)
                )
                for c in geometry.components
            )
            fn = _batched_transform(geometry, mesh)
            inp = tuple(
                jnp.asarray(
                    np.stack([r.coefficients[c.component_index] for r in batch])
                )
                for c in geometry.components
            )
        rgb = np.asarray(fn(inp, quants))
        if packed_batch is not None:  # delta path outputs planar CHW
            rgb = np.moveaxis(rgb, 1, -1)
        for j, i in enumerate(indices):
            out[i] = rgb[j]
    return out


def decode_stream_rgb(datas, *, depth: int = 4, scan_workers: int = 2,
                      device_workers: int = 1, group: int = 1,
                      scale: float = 1.0):
    """Pipelined streaming decode: yields device-resident RGB arrays in
    input order while the host scans ahead.

    Two levels of overlap: ``scan_workers`` host threads run the
    per-image stages (container parse + entropy scan — independent
    across images, and the native calls release the GIL) while
    ``device_workers`` threads run the transfer + transform dispatch
    (2 double-buffers the host->device transfer of image i+1 under the
    transform of image i); ``depth`` bounds in-flight work. The
    defaults (``depth=4``, ``device_workers=1``) are not measured on the
    GPU.

    ``group`` > 1 amortizes per-dispatch overhead: up to ``group``
    consecutive images whose payloads share geometry and bucket size
    run as ONE stacked vmapped device call (each still yielded
    individually, device-resident). Mixed-shape runs fall back to
    per-image dispatch within the group.

    ``scale`` in {1, 1/2, 1/4, 1/8} runs the reduced-IDCT thumbnail
    transform on device (same entropy scan, smaller device program and
    output — the thumbnail-serving mode).
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    import jax

    scale_n = int(round(8 * scale))
    if scale_n not in (1, 2, 4, 8) or abs(8 * scale - scale_n) > 1e-9:
        raise ValueError("scale must be 1, 1/2, 1/4 or 1/8")

    def scan(data):
        dec = JpegDecoder()
        dec.set_input(data)
        # Merged decode+sparse-pack when eligible (single-scan
        # baseline); otherwise dense decode + pack in this worker.
        res = dec.decode(sparse_direct=True)
        res.prepack()  # no-op when the merged path produced the payload
        return res

    def one_rgb(res):
        """Planar [3, H, W] uint8 (device-resident for DCT modes; the
        layout of DecodeResult.to_rgb8_device)."""
        if res.samples is not None:  # lossless: host path
            rgb = res.to_rgb8()
            if scale_n != 8:
                f = 8 // scale_n
                rgb = rgb[::f, ::f]
            return np.moveaxis(rgb, -1, 0)
        return res.to_rgb8_device(sparse=True, scale=scale)

    def transform_group(scan_futs):
        ress = [f.result() for f in scan_futs]
        # The grouped branches require the YCbCr/gray interpretation
        # (same coverage as to_rgb8_device, which the per-image path
        # enforces by raising); RGB-coded and CMYK streams fall through
        # to one_rgb and get its error.
        grouped_ok = (
            len(ress) > 1
            and all(_device_color_ok(r) for r in ress)
            and len({r.geometry for r in ress}) == 1
        )
        if grouped_ok:
            geo = ress[0].geometry
            stacked2 = _stack_payloads2(ress, geo)
            if stacked2 is not None:
                quants = _stacked_quants(ress, geo)
                out = _batched_mcu_transform2(geo, scale_n)(stacked2, quants)
                jax.block_until_ready(out)
                return [out[i] for i in range(len(ress))]
        groupable = (
            grouped_ok
            and all(r.packed_mcu is not None for r in ress)
            and len({r.packed_mcu.shape for r in ress}) == 1
        )
        if groupable:
            geo = ress[0].geometry
            quants = _stacked_quants(ress, geo)
            stacked = np.stack([r.packed_mcu for r in ress])
            out = _batched_mcu_transform(geo, scale_n)(stacked, quants)
            jax.block_until_ready(out)
            return [out[i] for i in range(len(ress))]
        outs = [one_rgb(r) for r in ress]
        jax.block_until_ready(outs)
        return outs

    with ThreadPoolExecutor(max_workers=scan_workers) as scan_pool, \
            ThreadPoolExecutor(max_workers=device_workers) as device_pool:
        inflight = deque()
        pending_scans = []

        def flush():
            if pending_scans:
                inflight.append(
                    device_pool.submit(transform_group, list(pending_scans))
                )
                pending_scans.clear()

        bound = max(depth, device_workers)
        for data in datas:
            pending_scans.append(scan_pool.submit(scan, data))
            if len(pending_scans) >= max(1, group):
                flush()
            while len(inflight) > bound:
                for rgb in inflight.popleft().result():
                    yield rgb
        flush()
        while inflight:
            for rgb in inflight.popleft().result():
                yield rgb


def _batched(fn, mesh):
    """vmap ``fn`` over a leading batch axis and compile it: for one
    device, or per shard over the mesh's ``data`` axis."""
    import jax
    from jax.sharding import PartitionSpec as P

    fn = jax.vmap(fn, in_axes=(0, 0))
    if mesh is None:
        return jax.jit(fn)
    from .sharding import shard_local

    return shard_local(fn, mesh, (P("data"), P("data")), P("data"))


@functools.lru_cache(maxsize=64)
def _batched_mcu_transform2(geometry, scale_n: int = 8, mesh=None):
    """vmapped v2-wire transform: [B, K] uint8 payload batch ->
    [B, 3, H, W] planar RGB (jit re-specializes per (B, bucket));
    bounded like its v1 sibling. With a mesh the batch shards over
    ``data``."""
    from ..ops.pipeline import jitted_transform_mcu2_inner

    return _batched(jitted_transform_mcu2_inner(geometry, "rgb8", "duplicate", scale_n), mesh)


@functools.lru_cache(maxsize=64)
def _batched_mcu_transform(geometry, scale_n: int = 8, mesh=None):
    """vmapped MCU-order sparse transform: [B, 2n] int16 payload batch
    -> [B, 3, H, W] planar RGB (jit re-specializes per (B, bucket)).
    Bounded like the sibling caches in ops/pipeline.py — a long-running
    server seeing many geometries must not accumulate executables
    forever."""
    from ..ops.pipeline import jitted_transform_mcu_inner

    return _batched(jitted_transform_mcu_inner(geometry, "rgb8", "duplicate", scale_n), mesh)


@functools.lru_cache(maxsize=64)
def _batched_transform_delta(geometry, scale_n: int = 8, mesh=None):
    """vmapped delta-sparse transform: [B, n, 2] int16 packed batch ->
    [B, H, W, 3] RGB."""
    from ..ops.pipeline import jitted_transform_delta

    return _batched(jitted_transform_delta(geometry, "rgb8", "duplicate", scale_n), mesh)


@functools.lru_cache(maxsize=64)
def _batched_transform(geometry, mesh=None):
    import jax.numpy as jnp

    from ..ops.pipeline import transform_to_rgb8

    return _batched(lambda cs, qs: transform_to_rgb8(cs, qs, geometry, xp=jnp), mesh)


def encode_batch_rgb(
    rgbs: Sequence[np.ndarray],
    quality: int = 75,
    *,
    max_workers: Optional[int] = None,
    **encode_kwargs,
) -> List[bytes]:
    """Data-parallel RGB encode: the batch twin of ``decode_batch_rgb``.

    Images fan out on the shared pool; every native encode stage
    releases the GIL, so small images (whose fused transform runs
    single-threaded below the internal threshold) parallelize across
    the pool while large images keep their internal stripe threading.
    Per-image failures propagate as exceptions from the returned
    position, matching the batch-decode isolation contract.

    ``encode_kwargs`` pass through to :func:`jpeglibrary_tpu.encode_rgb`
    (``subsampling``, ``optimize_coding``, ``restart_interval``,
    ``arithmetic``, ...).
    """
    from ..models.encoder import encode_rgb
    from ..utils.pool import shared_pool

    def one(rgb: np.ndarray) -> bytes:
        return encode_rgb(rgb, quality, **encode_kwargs)

    items = list(rgbs)
    if len(items) <= 1:
        return [one(items[0])] if items else []
    if max_workers is not None:
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            return list(pool.map(one, items))
    return list(shared_pool().map(one, items))
