"""Smoke run of the serving decode path on one GPU.

    python chip_smoke.py          # one card: phases (a)-(g)
    python chip_smoke.py --four   # four cards: the mesh decode path only

Drives the public entry points (``decode_stream_rgb``,
``decode_batch_rgb``, the scaled and stripe decoders, the device encode
transform, ``full_step``, the device entropy scan) at the sizes users
run, each against the host golden path, and prints one line per phase.
Inputs are seeded photographic-like images (numpy only), encoded by the
repo's own encoder:

- ref16mp: one 4096x4096 image, q75, 4:2:0, encoded with one restart
  interval per MCU row and with none (the reference benchmark's shape,
  DecoderBenchmark.cs:29-42);
- batch: 64 ImageNet-class 500x375 images, q75, 4:2:0, no restart.

The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``; it is printed only when every phase
passed. The script refuses to run without a GPU or without the native
entropy scanner. Wall times it prints sit beside the card's name and
power limit and are not a benchmark.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np

SEED = 1234
CARD = "no card"  # nvidia-smi's name and power limit, set by main()


@dataclasses.dataclass(frozen=True)
class Sizes:
    side: int = 4096  # ref16mp: side x side
    batch: int = 64  # ImageNet-class batch
    batch_hw: tuple = (375, 500)
    fdct_side: int = 2048
    step_batch: int = 8
    step_blocks: int = 128  # full_step luma blocks per side (1024^2 px)
    scan_side: int = 512
    stripe_rows: int = 16  # MCU rows per stripe in the stripe decode
    reps: int = 3


FULL = Sizes()


@dataclasses.dataclass
class Inputs:
    ref_blobs: Dict[str, bytes]  # "restart" / "norestart"
    batch_blobs: List[bytes]


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def on_device(arr, what: str) -> None:
    """``arr`` lives on the accelerator JAX chose (the GPU in main)."""
    import jax

    want = jax.devices()[0].platform
    platforms = {d.platform for d in arr.devices()}
    check(platforms == {want}, f"{what}: output on {platforms}, not {want}")


def memory(name: str, jitted, *args) -> None:
    """Print the compiled program's memory analysis."""
    m = jitted.lower(*args).compile().memory_analysis()
    log(
        f"  memory {name}: argument={m.argument_size_in_bytes} "
        f"output={m.output_size_in_bytes} temp={m.temp_size_in_bytes} "
        f"generated_code={m.generated_code_size_in_bytes}"
    )


def _decode(blob: bytes):
    from jpeglibrary_tpu.models.decoder import JpegDecoder

    dec = JpegDecoder()
    dec.set_input(blob)
    return dec.decode(sparse_direct=True)


def _quants(res) -> np.ndarray:
    return np.stack(
        [res.quant[c.component_index] for c in res.geometry.components]
    ).astype(np.int32)


def make_inputs(sizes: Sizes, *, batch: bool = True) -> Inputs:
    from jpeglibrary_tpu.models.encoder import encode_rgb
    from jpeglibrary_tpu.utils.synthetic import photo

    img = photo(sizes.side, sizes.side, seed=SEED)
    mcus_per_line = -(-sizes.side // 16)
    ref = {
        "restart": encode_rgb(img, 75, subsampling="420", restart_interval=mcus_per_line),
        "norestart": encode_rgb(img, 75, subsampling="420"),
    }
    blobs = []
    if batch:
        h, w = sizes.batch_hw
        blobs = [
            encode_rgb(photo(h, w, seed=SEED + 1 + i), 75, subsampling="420")
            for i in range(sizes.batch)
        ]
    return Inputs(ref, blobs)


def phase_decode(inp: Inputs, sizes: Sizes) -> None:
    """(a) ref16mp through decode_stream_rgb and the batch through
    decode_batch_rgb, against the host golden path."""
    import jax

    from jpeglibrary_tpu.ops.pipeline import jitted_transform_mcu2
    from jpeglibrary_tpu.parallel.batch import (
        _batched_mcu_transform2,
        _stack_payloads2,
        _stacked_quants,
        decode_batch_rgb,
        decode_stream_rgb,
    )
    from jpeglibrary_tpu.utils.tolerance import rgb_mismatch

    for name, blob in inp.ref_blobs.items():
        res = _decode(blob)
        check(res.packed_mcu2 is not None, f"ref16mp {name}: no v2 wire payload")
        host = res.to_rgb8()
        list(decode_stream_rgb([blob]))  # compile
        t0 = time.perf_counter()
        outs = list(decode_stream_rgb([blob] * sizes.reps))
        jax.block_until_ready(outs)
        dt = time.perf_counter() - t0
        n_diff = 0
        for o in outs:
            on_device(o, f"ref16mp {name}")
            n_diff = max(n_diff, rgb_mismatch(np.moveaxis(np.asarray(o), 0, -1), host, name))
        log(
            f"  ref16mp {name}: {len(blob)} bytes, differing values {n_diff}/{host.size}, "
            f"{dt / sizes.reps:.4f} s/image wall over {sizes.reps} ({CARD})"
        )
        if name == "norestart":
            memory("ref16mp transform", jitted_transform_mcu2(res.geometry), res.packed_mcu2, _quants(res))

    decode_batch_rgb(inp.batch_blobs)  # compile
    t0 = time.perf_counter()
    outs = decode_batch_rgb(inp.batch_blobs)
    dt = time.perf_counter() - t0
    n_diff = total = 0
    ress = [_decode(b) for b in inp.batch_blobs]
    for o, r in zip(outs, ress):
        host = r.to_rgb8()
        n_diff += rgb_mismatch(o, host, "batch image")
        total += host.size
    log(
        f"  batch {len(outs)}x{sizes.batch_hw[0]}x{sizes.batch_hw[1]}: differing values "
        f"{n_diff}/{total}, {dt:.4f} s wall for the batch ({CARD})"
    )
    geo = ress[0].geometry
    memory(
        "batch transform", _batched_mcu_transform2(geo, 8),
        _stack_payloads2(ress, geo), _stacked_quants(ress, geo),
    )


def phase_programs(inp: Inputs) -> None:
    """(b) the single-image and the batched program on the same input:
    each deterministic, and the two within the device contract."""
    from jpeglibrary_tpu.ops.pipeline import jitted_transform_mcu2
    from jpeglibrary_tpu.parallel.batch import (
        _batched_mcu_transform2,
        _stack_payloads2,
        _stacked_quants,
    )
    from jpeglibrary_tpu.utils.tolerance import rgb_mismatch

    res = _decode(inp.ref_blobs["norestart"])
    geo, payload, quants = res.geometry, res.packed_mcu2, _quants(res)
    single = jitted_transform_mcu2(geo)
    batched = _batched_mcu_transform2(geo, 8)
    a, a2 = np.asarray(single(payload, quants)), np.asarray(single(payload, quants))
    b = batched(payload[None], quants[None])
    on_device(b, "batched program")
    b, b2 = np.asarray(b), np.asarray(batched(payload[None], quants[None]))
    check(np.array_equal(a, a2), "single-image program is not deterministic")
    check(np.array_equal(b, b2), "batched program is not deterministic")
    n_ref = rgb_mismatch(b[0], a, "ref16mp batched vs single")

    ress = [_decode(blob) for blob in inp.batch_blobs]
    geo = ress[0].geometry
    out = np.asarray(
        _batched_mcu_transform2(geo, 8)(_stack_payloads2(ress, geo), _stacked_quants(ress, geo))
    )
    single = jitted_transform_mcu2(geo)
    n_batch = sum(
        rgb_mismatch(out[i], np.asarray(single(r.packed_mcu2, _quants(r))), "batch batched vs single")
        for i, r in enumerate(ress)
    )
    log(f"  batched vs single program: ref16mp differing values {n_ref}, batch {n_batch}")
    memory("single-image program", single, ress[0].packed_mcu2, _quants(ress[0]))


def phase_scaled(inp: Inputs) -> None:
    """(c) scaled decode 1/2, 1/4, 1/8 on ref16mp, device against the
    host to_rgb8_scaled, within 1 sample LSB: the device sample planes
    are within 1 of the host's, and the serving program's RGB within the
    3 levels that 1 LSB in every component can make."""
    import functools

    import jax
    import jax.numpy as jnp

    from jpeglibrary_tpu.ops import decode_stage
    from jpeglibrary_tpu.ops.pipeline import jitted_transform_mcu2
    from jpeglibrary_tpu.utils.tolerance import MAX_ABS_ALL_COMPONENTS, rgb_mismatch

    res = _decode(inp.ref_blobs["norestart"])
    geo = res.geometry
    counts = []
    for scale in (0.5, 0.25, 0.125):
        n = int(8 * scale)
        out_h, out_w = -(-geo.height * n // 8), -(-geo.width * n // 8)
        n_samples = total = 0
        for cg in geo.components:
            coeffs = res.coefficients[cg.component_index]
            quant = res.quant[cg.component_index].astype(np.int32)
            args = (geo.level_shift, cg.hs, cg.vs, out_h, out_w, n)
            host = decode_stage.component_plane_scaled(coeffs, quant, *args)
            dev = jax.jit(functools.partial(decode_stage.component_plane_scaled, xp=jnp),
                          static_argnums=range(2, 8))(coeffs, quant, *args)
            d = np.abs(np.asarray(dev).astype(np.int64) - host)
            check(d.max() <= 1, f"scale {scale} component {cg.component_index}: max |diff| {d.max()}")
            n_samples += int(np.count_nonzero(d))
            total += d.size
        dev = res.to_rgb8_device(scale=scale)
        on_device(dev, f"scale {scale}")
        host = res.to_rgb8_scaled(scale)
        n_rgb = rgb_mismatch(np.moveaxis(np.asarray(dev), 0, -1), host, f"scale {scale}",
                             max_abs=MAX_ABS_ALL_COMPONENTS, max_fraction=1.0)
        counts.append(f"1/{8 // n}: samples {n_samples}/{total}, rgb {n_rgb}/{host.size}")
    log(f"  scaled differing values {'; '.join(counts)}")
    memory(
        "scale 1/2 transform", jitted_transform_mcu2(geo, "rgb8", "duplicate", 4),
        res.packed_mcu2, _quants(res),
    )


def phase_stripes(inp: Inputs, sizes: Sizes) -> None:
    """(d) bounded-memory stripe decode of ref16mp against the full
    device decode."""
    from jpeglibrary_tpu.models.streaming import (
        _stripe_geometry,
        decode_rgb_stripes,
        split_payload2_stripes,
    )
    from jpeglibrary_tpu.ops.pipeline import jitted_transform_mcu2
    from jpeglibrary_tpu.utils.tolerance import rgb_mismatch

    blob = inp.ref_blobs["restart"]
    res = _decode(blob)
    full = np.asarray(jitted_transform_mcu2(res.geometry)(res.packed_mcu2, _quants(res)))
    rows = sizes.stripe_rows
    parts, y_next = [], 0
    for y0, stripe in decode_rgb_stripes(blob, stripe_mcu_rows=rows):
        on_device(stripe, "stripe")
        check(y0 == y_next, f"stripe starts at {y0}, expected {y_next}")
        parts.append(np.asarray(stripe))
        y_next = y0 + stripe.shape[1]
    got = np.concatenate(parts, axis=1)
    n = rgb_mismatch(got, full, "stripes vs full")
    log(f"  stripes: {len(parts)} stripes of {rows} MCU rows, differing values {n}/{full.size}")
    rows = min(rows, res.geometry.mcus_per_column)
    payloads, geo, quants, _ = split_payload2_stripes(res, rows)
    sgeo = _stripe_geometry(geo, rows, rows * 8 * geo.max_v)
    memory("stripe transform", jitted_transform_mcu2(sgeo), payloads[0], quants)


def phase_fdct(sizes: Sizes) -> None:
    """(e) device encode transform against the host encode: quantized
    coefficients within 1."""
    import jax.numpy as jnp

    import jpeglibrary_tpu as jt
    from jpeglibrary_tpu.ops import encode_stage
    from jpeglibrary_tpu.utils.synthetic import photo

    side = sizes.fdct_side
    img = photo(side, side, seed=SEED + 1000)
    host = jt.decode(jt.encode_rgb(img, 75))
    dev = jt.decode(jt.encode_rgb(img, 75, xp=jnp))
    n = total = 0
    for k in host.coefficients:
        d = np.abs(host.coefficients[k].astype(np.int32) - dev.coefficients[k].astype(np.int32))
        check(d.max() <= 1, f"device FDCT component {k}: max |diff| {d.max()}")
        n += int(np.count_nonzero(d))
        total += d.size
    log(f"  device FDCT {side}x{side}: differing coefficients {n}/{total}")
    mcus = -(-side // 16)
    fwd = encode_stage.jitted_forward(((2, 2, 1, 1), (1, 1, 2, 2), (1, 1, 2, 2)), mcus, mcus, 128.0)
    planes = tuple(np.zeros((side, side), np.uint8) for _ in range(3))
    memory("device FDCT", fwd, planes, np.ones((3, 64), np.int32))


def _gather(rows):
    """Host symbol gather summed over MCU-ordered block rows."""
    from jpeglibrary_tpu.ops import encode_stage

    dc, ac = np.zeros(256, np.int64), np.zeros(256, np.int64)
    for row in rows:
        d, a = encode_stage.dc_ac_symbol_frequencies(np.ascontiguousarray(row))
        dc += d
        ac += a
    return dc, ac


def _full_step_host(y, cb, cr, qt_l, qt_c):
    """numpy evaluation of full_step: the same transform on the host and
    the host symbol gather for the histograms."""
    from jpeglibrary_tpu.parallel.sharding import _mcu_order_batch, full_step_transform

    rgb, ry, rcb, rcr = full_step_transform(y, cb, cr, qt_l, qt_c, np)
    b = ry.shape[0]
    chroma = np.concatenate([rcb.reshape(b, -1, 64), rcr.reshape(b, -1, 64)])
    hists = np.stack(_gather(_mcu_order_batch(ry, 2, 2, np)) + _gather(chroma))
    return rgb, ry, hists


def phase_full_step(sizes: Sizes) -> None:
    """(f) the graft entry's full_step against its numpy evaluation."""
    import jax

    import __graft_entry__ as ge
    from jpeglibrary_tpu.parallel.sharding import _mcu_order_batch
    from jpeglibrary_tpu.utils.tolerance import rgb_mismatch

    fn, _ = ge.entry()
    args = ge._example_args(batch=sizes.step_batch, hb=sizes.step_blocks, wb=sizes.step_blocks)
    step = jax.jit(fn)
    rgb, requant, hists = step(*args)
    on_device(rgb, "full_step rgb")
    rgb, requant, hists = np.asarray(rgb), np.asarray(requant), np.asarray(hists)
    rgb_h, requant_h, hists_h = _full_step_host(*args)
    n_rgb = rgb_mismatch(rgb, rgb_h, "full_step rgb")
    d = np.abs(requant.astype(np.int32) - requant_h.astype(np.int32))
    check(d.max() <= 1, f"full_step requant: max |diff| {d.max()}")
    n_q = int(np.count_nonzero(d))
    check(n_q <= d.size * 1e-3, f"full_step requant: {n_q}/{d.size} differ")
    # The device histograms of the device's own coefficients are exact.
    dc, ac = _gather(_mcu_order_batch(requant, 2, 2, np))
    check(np.array_equal(hists[0], dc) and np.array_equal(hists[1], ac),
          "full_step luma histograms differ from the host gather of its coefficients")
    l1 = int(np.abs(hists.astype(np.int64) - hists_h).sum())
    check(l1 <= hists_h.sum() * 1e-3, f"full_step histograms: L1 {l1} vs numpy step")
    log(
        f"  full_step batch {sizes.step_batch} x {sizes.step_blocks * 8}^2: differing rgb "
        f"{n_rgb}/{rgb.size}, requant {n_q}/{d.size}, histogram L1 {l1}"
    )
    memory("full_step", step, *args)


def _segment_truth(blob: bytes, geo, ri: int):
    """Host decode re-laid-out as per-segment MCU-order dense rows."""
    import jpeglibrary_tpu as jt

    ref = jt.decode(blob)
    cpm = 64 * sum(c.h * c.v for c in geo.components)
    per_mcu = np.zeros((geo.mcus_per_column * geo.mcus_per_line, cpm), np.int32)
    off = 0
    for c in geo.components:
        size = c.h * c.v * 64
        blk = ref.coefficients[c.component_index].astype(np.int32)
        per_mcu[:, off : off + size] = (
            blk.reshape(geo.mcus_per_column, c.v, geo.mcus_per_line, c.h, 64)
            .transpose(0, 2, 1, 3, 4)
            .reshape(-1, size)
        )
        off += size
    return [per_mcu[i : i + ri].reshape(-1) for i in range(0, per_mcu.shape[0], ri)]


def phase_device_scan(sizes: Sizes) -> None:
    """(g) the device entropy scan, bit-exact against the host scan."""
    import jpeglibrary_tpu as jt
    from jpeglibrary_tpu.ops import device_scan
    from jpeglibrary_tpu.utils.synthetic import photo

    side = sizes.scan_side
    ri = -(-side // 16)  # one restart interval per MCU row
    blob = jt.encode_rgb(photo(side, side, seed=SEED + 2000), 75, subsampling="420", restart_interval=ri)
    buf, const, geo = device_scan.prepare_baseline(blob)
    fn, args = device_scan.decoder_program(buf, const)
    out = fn(*args)
    on_device(out, "device scan")
    out = np.asarray(out)
    segs = _segment_truth(blob, geo, ri)
    for i, seg in enumerate(segs):
        check(np.array_equal(out[i, : seg.shape[0]], seg), f"device scan segment {i} differs")
    log(f"  device scan {side}x{side}: {len(segs)} segments bit-exact")
    memory("device scan", fn, *args)


def phase_four(inp: Inputs, n: int = 4) -> None:
    """The mesh APIs over n devices against the one-device result:
    the multi-device dry run, decode_batch_rgb over a ``data`` mesh and
    decode_rgb_sharded over ``stripe``; checks that the work really
    spreads over all n devices."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import __graft_entry__ as ge
    from jpeglibrary_tpu.ops.pipeline import jitted_transform_mcu2
    from jpeglibrary_tpu.parallel.batch import _batched_mcu_transform2, decode_batch_rgb
    from jpeglibrary_tpu.parallel.sharding import assemble_stripes, decode_rgb_sharded, make_mesh
    from jpeglibrary_tpu.utils.tolerance import rgb_mismatch

    check(len(jax.devices()) >= n, f"needs {n} devices, found {len(jax.devices())}")
    ge.dryrun_multichip(n)
    log(f"  dryrun_multichip({n}) passed")

    blob = inp.ref_blobs["norestart"]
    mesh = make_mesh(n, stripe=1)
    one = decode_batch_rgb([blob] * n)
    many = decode_batch_rgb([blob] * n, mesh=mesh)
    n_batch = sum(rgb_mismatch(b, a, f"mesh batch image {i}") for i, (a, b) in enumerate(zip(one, many)))

    res = _decode(blob)
    payloads = np.stack([res.packed_mcu2] * n)
    quants = np.stack([_quants(res)] * n)
    sharded = jax.device_put(payloads, NamedSharding(mesh, P("data")))
    prog = _batched_mcu_transform2(res.geometry, 8, mesh)
    out = prog(sharded, quants)
    jax.block_until_ready(out)
    devs = {s.device for s in out.addressable_shards}
    check(len(devs) == n, f"data mesh output on {len(devs)} devices, not {n}")
    check(all(s.data.shape[0] == 1 for s in out.addressable_shards), "uneven data shards")
    # Each device transforms only its own images: no collective moves
    # payloads or pixels between the cards.
    hlo = prog.lower(sharded, quants).compile().as_text()
    n_coll = len(re.findall(r"\b(?:all-gather|all-reduce|all-to-all|collective-permute|reduce-scatter)(?:-start)?\(", hlo))
    check(n_coll == 0, f"data mesh program holds {n_coll} collectives")

    smesh = make_mesh(n, stripe=n)
    stripes, heights = decode_rgb_sharded(blob, smesh)
    jax.block_until_ready(stripes)
    sdevs = {s.device for s in stripes.addressable_shards}
    check(len(sdevs) == n, f"stripe mesh output on {len(sdevs)} devices, not {n}")
    single = np.asarray(jitted_transform_mcu2(res.geometry)(res.packed_mcu2, _quants(res)))
    n_stripe = rgb_mismatch(assemble_stripes(stripes, heights), single, "stripe-sharded vs single")
    log(
        f"  {n}-device data mesh: differing values {n_batch}, output on {len(devs)} devices, "
        f"{n_coll} collectives; "
        f"stripe mesh: differing values {n_stripe}, output on {len(sdevs)} devices"
    )
    memory(f"{n}-device batch transform", prog, sharded, quants)


def _card() -> str:
    """nvidia-smi's name and power limit of the cards, one line each."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _label(card: str) -> str:
    """One-line label of ``_card()`` to print beside wall times."""
    lines = card.splitlines()
    return lines[0] if len(lines) == 1 else f"{len(lines)} x {'; '.join(sorted(set(lines)))}"


def run_phase(label: str, fn, *args) -> None:
    t0 = time.perf_counter()
    fn(*args)
    log(f"phase {label}: ok ({time.perf_counter() - t0:.1f} s wall incl. compile, {CARD})")


def main(argv=None) -> int:
    global CARD
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four", action="store_true", help="run the four-card mesh path only")
    args = parser.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU: JAX's first device is on {dev.platform!r}", file=sys.stderr)
        return 2
    n_cards = 4 if args.four else 1
    if len(jax.devices()) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, found {len(jax.devices())}", file=sys.stderr)
        return 2

    card = _card()
    log(f"card: {card}")
    CARD = _label(card)
    log(f"host cpus: {os.cpu_count()}")
    # A failed native build raises here: the pure-Python scanner must
    # not stand in for the native one.
    from jpeglibrary_tpu.native import build

    log(f"native scanner: {build.load_library()._name}")
    import jpeglibrary_tpu as jt

    jt.enable_compile_cache()
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")

    t0 = time.perf_counter()
    if args.four:
        inp = make_inputs(FULL, batch=False)
        log(f"inputs: {time.perf_counter() - t0:.1f} s")
        run_phase("four", phase_four, inp, 4)
    else:
        inp = make_inputs(FULL)
        log(f"inputs: {time.perf_counter() - t0:.1f} s")
        run_phase("a decode", phase_decode, inp, FULL)
        run_phase("b programs", phase_programs, inp)
        run_phase("c scaled", phase_scaled, inp)
        run_phase("d stripes", phase_stripes, inp, FULL)
        run_phase("e device FDCT", phase_fdct, FULL)
        run_phase("f full_step", phase_full_step, FULL)
        run_phase("g device scan", phase_device_scan, FULL)
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
