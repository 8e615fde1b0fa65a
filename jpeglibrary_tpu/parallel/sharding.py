"""Mesh policy and sharded batch pipelines.

Replaces the reference's "one decoder instance per image, one thread"
model (JpegDecoder.cs:19) with SPMD over a ``jax.sharding.Mesh``:

- axis ``data``: independent images (or restart segments) — the JPEG
  analogue of data parallelism.
- axis ``stripe``: MCU block rows within an image — the sequence/context
  parallel axis for the transform stages (IDCT/upsample/color are
  block-row local, so stripes shard with zero halo).

Encoder/optimizer symbol statistics are reduced across the whole mesh
(the psum-histogram pattern from SURVEY.md §2.4), mirroring how the
reference gathers per-block statistics serially
(JpegEncoder.GatherBlockStatistics, JpegEncoder.cs:551-603).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def make_mesh(n_devices: Optional[int] = None, *, stripe: int = 1):
    """Build a ('data', 'stripe') mesh over the first n devices."""
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices % stripe != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by stripe={stripe}")
    devs = np.asarray(devices[:n_devices]).reshape(n_devices // stripe, stripe)
    return Mesh(devs, ("data", "stripe"))


def shard_local(fn, mesh, in_specs, out_specs):
    """``jax.jit`` of ``fn`` run by every device on its own shard
    (``shard_map``). The decode programs hold a Triton kernel on the GPU
    (ops.idct_kernel), a custom call XLA's partitioner has no sharding
    rule for; per-shard programs keep each device on its own data with
    no collective (checked by ``chip_smoke.py --four``)."""
    import jax

    return jax.jit(
        jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False)
    )


def _fdct_quantize_batch(planes, qt_zz, xp):
    """[B, H, W] int samples -> [B, Hb, Wb, 64] int16 zig-zag coeffs:
    level shift + folded-GEMM AAN FDCT + quantize (one matrix product
    per image; same math as ops.encode_stage.fdct_quantize)."""
    from ..ops import dct, encode_stage

    b, h, w = planes.shape
    hb, wb = h // 8, w // 8
    blocks = (
        planes.reshape(b, hb, 8, wb, 8)
        .transpose(0, 1, 3, 2, 4)
        .reshape(b, hb * wb, 64)
        .astype(xp.float32)
        - xp.float32(128.0)
    )
    k = xp.asarray(encode_stage.fdct_zigzag_matrix())
    zz = dct.matmul(blocks, k, xp=xp)
    q = qt_zz.astype(xp.float32)
    return xp.rint(zz / q).astype(xp.int16).reshape(b, hb, wb, 64)


def _mcu_order_batch(coeffs, h, v, xp):
    """[B, Hb, Wb, 64] -> [B, N, 64] in the interleaved MCU walk order
    (per MCU: v rows x h cols of blocks) — the order the DC predictor
    chain runs in (JpegEncoder.cs:512-536)."""
    b, hb, wb, _ = coeffs.shape
    mr, mc = hb // v, wb // h
    x = coeffs.reshape(b, mr, v, mc, h, 64)
    return xp.transpose(x, (0, 1, 3, 2, 4, 5)).reshape(b, mr * mc * v * h, 64)


def full_step(y_coeffs, cb_coeffs, cr_coeffs, qt_luma, qt_chroma):
    """The framework's flagship device step over a batch of 4:2:0 images:

    decode transform (dequant + IDCT + level shift + upsample + YCbCr->RGB)
    -> full re-encode transform (RGB -> YCbCr, 2x2 box subsample of the
       chroma planes, FDCT + quantize of all three components)
    -> true Huffman symbol statistics: DC-difference-category and
       AC-(run,size) histograms per table class, all-reduced over the
       mesh — exactly what the 2-pass encoder's table builder consumes
       (cf. JpegEncoder.GatherBlockStatistics, JpegEncoder.cs:551-601).

    Shapes (B = batch, Hb/Wb = luma blocks):
      y_coeffs  int16 [B, Hb, Wb, 64]      (zig-zag)
      cb/cr     int16 [B, Hb/2, Wb/2, 64]
      qt_luma / qt_chroma  int32 [64]      (zig-zag)

    Returns (rgb uint8 [B, H, W, 3], requant_y int16 [B, Hb, Wb, 64]
    zig-zag, hists int32 [4, 256]: dc_luma, ac_luma, dc_chroma,
    ac_chroma).
    """
    import jax.numpy as jnp

    from ..ops import encode_stage

    xp = jnp
    b = y_coeffs.shape[0]
    rgb, requant_y, requant_cb, requant_cr = full_step_transform(
        y_coeffs, cb_coeffs, cr_coeffs, qt_luma, qt_chroma, xp
    )

    # ---- true symbol statistics (histogram all-reduce over the mesh) ----
    y_mcu = _mcu_order_batch(requant_y, 2, 2, xp)
    chroma_mcu = xp.concatenate(
        [requant_cb.reshape(b, -1, 64), requant_cr.reshape(b, -1, 64)], axis=0
    )  # each chroma component is its own DC predictor chain
    dc_l, ac_l = encode_stage.symbol_histograms_device(y_mcu, xp)
    dc_c, ac_c = encode_stage.symbol_histograms_device(chroma_mcu, xp)
    hists = xp.stack([dc_l, ac_l, dc_c, ac_c])
    return rgb, requant_y, hists


def full_step_transform(y_coeffs, cb_coeffs, cr_coeffs, qt_luma, qt_chroma, xp):
    """The transform half of :func:`full_step` for any array module
    (numpy evaluates the same step on the host): returns (rgb,
    requant_y, requant_cb, requant_cr)."""
    from ..ops import color as color_ops
    from ..ops import decode_stage

    b = y_coeffs.shape[0]

    # ---- decode transform ----
    def comp_plane(cz, qz, up):
        s = decode_stage.dequantize_idct_shift(cz, qz, 128, xp=xp)
        plane = xp.transpose(s, (0, 1, 3, 2, 4)).reshape(s.shape[0], s.shape[1] * 8, s.shape[2] * 8)
        if up != 1:
            plane = xp.repeat(xp.repeat(plane, up, axis=1), up, axis=2)
        return plane

    y_plane = comp_plane(y_coeffs, qt_luma, 1)
    cb_plane = comp_plane(cb_coeffs, qt_chroma, 2)
    cr_plane = comp_plane(cr_coeffs, qt_chroma, 2)

    y8 = decode_stage.clamp_to_uint8(y_plane, xp=xp)
    cb8 = decode_stage.clamp_to_uint8(cb_plane, xp=xp)
    cr8 = decode_stage.clamp_to_uint8(cr_plane, xp=xp)
    r, g, bl = color_ops.ycbcr_to_rgb(y8, cb8, cr8, xp=xp)
    rgb = xp.stack([r, g, bl], axis=-1)

    # ---- re-encode transform: all three components ----
    y2, cb2, cr2 = color_ops.rgb_to_ycbcr(r, g, bl, xp=xp)

    def box2x2(p):
        # (sum + 2) >> 2 round-half-up, the reference subsample rounding
        # (ReadBlockWithSubsample, JpegEncoder.cs:756-787)
        x = p.astype(xp.int32).reshape(b, p.shape[1] // 2, 2, p.shape[2] // 2, 2)
        return (xp.sum(x, axis=(2, 4)) + 2) >> 2

    requant_y = _fdct_quantize_batch(y2.astype(xp.int32), qt_luma, xp)
    requant_cb = _fdct_quantize_batch(box2x2(cb2), qt_chroma, xp)
    requant_cr = _fdct_quantize_batch(box2x2(cr2), qt_chroma, xp)
    return rgb, requant_y, requant_cb, requant_cr


def mesh_symbol_frequencies(blocks: np.ndarray, mesh):
    """Distributed 2-pass-encoder statistics: DC/AC Huffman symbol
    histograms for one component's MCU-ordered blocks, computed on
    device with the block axis sharded over the mesh's ``data`` axis and
    the histograms all-reduced (psum) — the production replacement for
    the host gather when a mesh is active (SURVEY.md §2.4 comm-backend
    row; serial reference: JpegEncoder.GatherBlockStatistics,
    JpegEncoder.cs:551-601).

    Bit-identical to ops.encode_stage.dc_ac_symbol_frequencies: blocks
    are zero-padded to shard evenly and masked out of every count; the
    DC-difference shift across shard boundaries lowers to an XLA
    collective permute.

    Returns (dc_freq[256], ac_freq[256]) as int64 numpy arrays.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops import encode_stage

    n = blocks.shape[0]
    d = mesh.shape["data"]
    pad = (-n) % d
    padded = np.zeros((1, n + pad, 64), dtype=np.int16)
    padded[0, :n] = blocks
    arr = jax.device_put(padded, NamedSharding(mesh, P(None, "data")))
    n_valid = jnp.asarray([n], dtype=jnp.int32)

    rep = NamedSharding(mesh, P())
    fn = jax.jit(
        lambda bl, nv: encode_stage.symbol_histograms_device(bl, jnp, n_valid=nv),
        out_shardings=(rep, rep),
    )
    dc, ac = fn(arr, n_valid)
    return np.asarray(dc).astype(np.int64), np.asarray(ac).astype(np.int64)


def make_sharded_full_step(mesh):
    """pjit full_step over the mesh: batch over 'data', MCU block rows
    over 'stripe'; the histogram output is replicated (XLA inserts the
    all-reduce)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    img = NamedSharding(mesh, P("data", "stripe"))
    tbl = NamedSharding(mesh, P())
    return jax.jit(
        full_step,
        in_shardings=(img, img, img, tbl, tbl),
        out_shardings=(img, img, tbl),
    )


def decode_rgb_sharded(data: bytes, mesh, *, axis: str = "stripe"):
    """Decode ONE image with its transform sharded over the mesh's
    MCU-row-stripe axis — the SP/CP pattern applied to the decode path
    (SURVEY.md §2.4). IDCT/upsample/color are block-row local, so
    stripes shard with zero halo, for EVERY mode:

    - single-scan baseline: the merged-scan sparse payload splits into
      contiguous per-stripe slices (entries are MCU-row ordered) and
      each device densifies + transforms its stripes locally;
    - progressive / arithmetic (dense coefficient planes accumulated
      across scans, the reference's JpegBlockAllocator analogue): each
      component plane splits into MCU-block-row stripes;
    - lossless (SOF3 raw sample planes): sample rows split on the
      max_v grid; upsample + normalize + color run per stripe.

    Returns ``(stripes, heights)``: a sharded device array
    [S, 3, stripe_px, W] laid out over the mesh axis, and the true
    pixel height of each stripe (the tail stripe's grid padding decodes
    to empty rows — crop with ``assemble_stripes``).
    """
    from ..models.decoder import JpegDecoder

    dec = JpegDecoder()
    dec.set_input(data)
    res = dec.decode(sparse_direct=True)
    if res.packed_mcu2 is not None:
        return _sharded_baseline_sparse2(res, mesh, axis)
    if res.packed_mcu is not None:
        return _sharded_baseline_sparse(res, mesh, axis)
    if res.samples is not None:
        return _sharded_lossless(res, mesh, axis)
    return _sharded_dense_coefficients(res, mesh, axis)


def _sharded_baseline_sparse2(res, mesh, axis: str):
    """Single-scan baseline on the v2 wire: per-stripe slices of the
    split-stream payload (0.4-0.6x the v1 stripe transfer bytes)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from ..models.geometry import ceil_div
    from ..models.streaming import _stripe_geometry, split_payload2_stripes
    from ..ops.pipeline import jitted_transform_mcu2_inner

    geo = res.geometry
    S = mesh.shape[axis]
    stripe_rows = ceil_div(geo.mcus_per_column, S)
    payloads, geo, quants, heights = split_payload2_stripes(res, stripe_rows)
    if payloads.shape[0] < S:  # short image: pad with empty stripes
        pad = np.zeros(
            (S - payloads.shape[0], payloads.shape[1]), dtype=np.uint8
        )
        payloads = np.concatenate([payloads, pad])
        heights = heights + [0] * (S - len(heights))

    sgeo = _stripe_geometry(geo, stripe_rows, stripe_rows * 8 * geo.max_v)
    inner = jitted_transform_mcu2_inner(sgeo, "rgb8")
    fn = shard_local(jax.vmap(inner, in_axes=(0, None)), mesh, (P(axis), P()), P(axis))
    return fn(payloads, quants), heights


def _sharded_baseline_sparse(res, mesh, axis: str):
    """Single-scan baseline: per-stripe slices of the sparse payload."""
    import jax
    from jax.sharding import PartitionSpec as P

    from ..models.geometry import ceil_div
    from ..models.streaming import _stripe_geometry, split_payload_stripes
    from ..ops.pipeline import jitted_transform_mcu_inner

    geo = res.geometry
    S = mesh.shape[axis]
    stripe_rows = ceil_div(geo.mcus_per_column, S)
    payloads, geo, quants, heights = split_payload_stripes(res, stripe_rows)
    if payloads.shape[0] < S:  # short image: pad with empty stripes
        pad = np.zeros((S - payloads.shape[0], payloads.shape[1]), dtype=np.int16)
        payloads = np.concatenate([payloads, pad])
        heights = heights + [0] * (S - len(heights))

    # Uniform stripe geometry, uncropped height (assembly crops).
    sgeo = _stripe_geometry(geo, stripe_rows, stripe_rows * 8 * geo.max_v)
    inner = jitted_transform_mcu_inner(sgeo, "rgb8")
    fn = shard_local(jax.vmap(inner, in_axes=(0, None)), mesh, (P(axis), P()), P(axis))
    return fn(payloads, quants), heights


def _sharded_dense_coefficients(res, mesh, axis: str):
    """Progressive/arithmetic (and any dense-plane) decode: shard the
    final transform of the accumulated coefficient planes — the
    reference runs this whole pass serially at Dispose()
    (JpegHuffmanProgressiveScanDecoder.cs:421-470)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..models.geometry import ceil_div
    from ..models.streaming import _stripe_geometry
    from ..ops.pipeline import transform_to_rgb8

    geo = res.geometry
    S = mesh.shape[axis]
    stripe_rows = ceil_div(geo.mcus_per_column, S)
    px = stripe_rows * 8 * geo.max_v
    sgeo = _stripe_geometry(geo, stripe_rows, px)

    stripes = []
    for c in geo.components:
        plane = res.coefficients[c.component_index]  # [Hb, Wb, 64]
        rows = stripe_rows * c.v
        padded = np.zeros((S * rows, plane.shape[1], 64), dtype=plane.dtype)
        padded[: plane.shape[0]] = plane
        stripes.append(padded.reshape(S, rows, plane.shape[1], 64))
    quants = tuple(
        jnp.asarray(res.quant[c.component_index], dtype=jnp.int32)
        for c in geo.components
    )
    heights = [max(0, min(px, geo.height - i * px)) for i in range(S)]

    fn = shard_local(
        jax.vmap(
            lambda cs, qs: transform_to_rgb8(cs, qs, sgeo, xp=jnp, layout="chw"),
            in_axes=(0, None),
        ),
        mesh, (P(axis), P()), P(axis),
    )
    return fn(tuple(stripes), quants), heights


def _sharded_lossless(res, mesh, axis: str):
    """Lossless (SOF3): raw sample planes shard on the max_v row grid;
    upsample-duplicate + precision normalize + YCbCr->RGB run per
    stripe (the row-local tail of the reference's
    JpegPartialScanlineAllocator flush, JpegPartialScanlineAllocator.cs:91-181)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..models.geometry import ceil_div
    from ..models.lossless import component_sizes
    from ..ops import color as color_ops
    from ..ops import decode_stage

    geo = res.geometry
    S = mesh.shape[axis]
    H, W = geo.height, geo.width
    max_v = geo.max_v
    rows_total = ceil_div(H, max_v)  # lossless MCU rows
    stripe_mcus = ceil_div(rows_total, S)
    px = stripe_mcus * max_v
    sizes = component_sizes(res.frame)

    if len(geo.components) not in (1, 3):
        raise ValueError(
            f"RGB output needs 1 or 3 components, got {len(geo.components)}."
        )

    stripes = []
    infos = []  # (true component width, hs, vs)
    for c in geo.components:
        plane = res.samples[c.component_index]  # padded grid [rows*v, cols*h]
        rows = stripe_mcus * c.v
        padded = np.zeros((S * rows, plane.shape[1]), dtype=plane.dtype)
        padded[: plane.shape[0]] = plane
        stripes.append(padded.reshape(S, rows, plane.shape[1]))
        infos.append((sizes[c.component_index][1], c.hs, c.vs))

    def inner(cs):
        u8 = []
        for s, (wc, hs, vs) in zip(cs, infos):
            p = s[:, :wc].astype(jnp.int32)
            p = decode_stage.upsample_duplicate(p, hs, vs, xp=jnp)[:, :W]
            u8.append(decode_stage.normalize_to_uint8(p, geo.precision, xp=jnp))
        if len(u8) == 1:
            y = u8[0]
            half = jnp.full_like(y, 128)
            r, g, b = color_ops.ycbcr_to_rgb(y, half, half, xp=jnp)
        else:
            r, g, b = color_ops.ycbcr_to_rgb(u8[0], u8[1], u8[2], xp=jnp)
        return jnp.stack([r, g, b], axis=0)

    heights = [max(0, min(px, H - i * px)) for i in range(S)]
    sh = NamedSharding(mesh, P(axis))
    fn = jax.jit(
        jax.vmap(inner, in_axes=(0,)),
        in_shardings=(tuple(sh for _ in stripes),),
        out_shardings=sh,
    )
    out = fn(tuple(jax.device_put(s, sh) for s in stripes))
    return out, heights


def assemble_stripes(stripes, heights) -> np.ndarray:
    """Host assembly of decode_rgb_sharded output: [3, H, W] uint8."""
    parts = []
    arr = np.asarray(stripes)
    for i, h in enumerate(heights):
        if h > 0:
            parts.append(arr[i][:, :h, :])
    return np.concatenate(parts, axis=1)


def batched_transform_rgb(coeffs_batch: Sequence, quants, geometry, mesh=None):
    """Decode-transform a batch of same-geometry images to RGB, sharded
    over ``data`` when a mesh is given."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..ops.pipeline import transform_to_rgb8

    stacked = tuple(
        jnp.stack([jnp.asarray(c[i]) for c in coeffs_batch]) for i in range(len(quants))
    )
    fn = jax.vmap(
        lambda cs, qs: transform_to_rgb8(cs, qs, geometry, xp=jnp),
        in_axes=(0, None),
    )
    fn = jax.jit(fn) if mesh is None else shard_local(fn, mesh, (P("data"), P()), P("data"))
    return fn(stacked, tuple(jnp.asarray(q) for q in quants))
