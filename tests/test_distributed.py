"""Multi-process (multi-"host") distributed execution test.

SURVEY.md §4.5 calls for emulating multi-node with jax.distributed
multi-process runs and asserting bit-exact equality of sharded vs
single-device execution — this does exactly that: two local processes,
each with 2 virtual CPU devices, form a 4-device global mesh and run
the sharded full pipeline step; every process checks its addressable
output shards against the locally computed single-device reference.
"""

import pathlib
import socket
import subprocess
import sys
import textwrap

import pytest

_REPO = str(pathlib.Path(__file__).resolve().parent.parent)

_WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid = int(sys.argv[1]); port = sys.argv[2]
    sys.path.insert(0, sys.argv[3])
    from jpeglibrary_tpu.parallel import distributed
    distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2 and len(jax.devices()) == 4

    import numpy as np
    from jpeglibrary_tpu.parallel.sharding import full_step, make_sharded_full_step
    from jpeglibrary_tpu.parallel.distributed import make_global_mesh
    from jpeglibrary_tpu.syntax.quantization import (
        STANDARD_CHROMINANCE_ZIGZAG, STANDARD_LUMINANCE_ZIGZAG,
    )

    rng = np.random.default_rng(123)
    y = rng.integers(-128, 128, size=(4, 8, 16, 64), dtype=np.int16)
    cb = rng.integers(-64, 64, size=(4, 4, 8, 64), dtype=np.int16)
    cr = rng.integers(-64, 64, size=(4, 4, 8, 64), dtype=np.int16)
    qt_l = STANDARD_LUMINANCE_ZIGZAG.astype(np.int32)
    qt_c = STANDARD_CHROMINANCE_ZIGZAG.astype(np.int32)

    # single-device reference, computed locally in each process
    ref_rgb, ref_requant, ref_hist = jax.jit(full_step)(y, cb, cr, qt_l, qt_c)
    ref_rgb = np.asarray(ref_rgb)

    mesh = make_global_mesh(stripe=2)
    step = make_sharded_full_step(mesh)
    # Multi-process: host-local numpy must become global jax.Arrays
    # (inputs are identical on every process).
    from jax.sharding import NamedSharding, PartitionSpec as P

    img = NamedSharding(mesh, P("data", "stripe"))
    rep = NamedSharding(mesh, P())
    mk = lambda a, s: jax.make_array_from_callback(a.shape, s, lambda idx: a[idx])
    rgb, requant, hist = step(
        mk(y, img), mk(cb, img), mk(cr, img), mk(qt_l, rep), mk(qt_c, rep)
    )
    jax.block_until_ready((rgb, requant, hist))

    for shard in rgb.addressable_shards:
        got = np.asarray(shard.data)
        expect = ref_rgb[tuple(shard.index)]
        np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(np.asarray(hist.addressable_shards[0].data),
                                  np.asarray(ref_hist))
    assert list(distributed.local_batch_indices(5)) == list(range(pid, 5, 2))
    print(f"proc {pid} OK", flush=True)
    """
)


_REAL_WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid = int(sys.argv[1]); port = sys.argv[2]
    sys.path.insert(0, sys.argv[3])
    from jpeglibrary_tpu.parallel import distributed
    distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2 and len(jax.devices()) == 4

    import numpy as np
    import jpeglibrary_tpu as jt
    from jpeglibrary_tpu.models.encoder import encode_rgb
    from jpeglibrary_tpu.parallel.batch import decode_batch_rgb, _batched_transform
    from jpeglibrary_tpu.parallel.distributed import local_batch_indices, make_global_mesh

    # A 4-image batch of same-geometry photographic JPEGs
    # (deterministic in both processes: seeded).
    from jpeglibrary_tpu.utils.synthetic import photo
    from jpeglibrary_tpu.utils.tolerance import rgb_mismatch

    rgb0 = photo(120, 200, seed=7)
    base = encode_rgb(rgb0, 85)
    datas = [
        base,
        encode_rgb(rgb0[::-1], 80),
        encode_rgb(rgb0[:, ::-1], 80),
        encode_rgb(np.roll(rgb0, 100, axis=0), 80),
    ]

    # Host stage: each process entropy-decodes ONLY its images
    # (production pipeline: parse + native scan + dense coefficients).
    mine = list(local_batch_indices(len(datas)))
    local = {i: jt.decode(datas[i]) for i in mine}
    # ... and the production batch API end-to-end for its local slice.
    local_rgb = decode_batch_rgb([datas[i] for i in mine])

    # Device stage on the GLOBAL mesh: process p's images are placed on
    # p's addressable devices (batch laid out [proc0 imgs, proc1 imgs]).
    order = sorted(range(len(datas)), key=lambda i: (i % 2, i))  # strided -> blocks
    geo = local[mine[0]].geometry
    mesh = make_global_mesh(stripe=1)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())

    def global_coeff(comp_index):
        shape = (len(datas),) + local[mine[0]].coefficients[comp_index].shape

        def cb(idx):
            imgs = [order[j] for j in range(*idx[0].indices(len(datas)))]
            assert all(i in local for i in imgs), (pid, imgs, mine)
            stacked = np.stack([local[i].coefficients[comp_index] for i in imgs])
            return stacked[(slice(None),) + tuple(idx[1:])]

        return jax.make_array_from_callback(shape, sh, cb)

    coeffs = tuple(global_coeff(c.component_index) for c in geo.components)

    def global_quant(comp_index):
        # Per-image quant tables, batch-sharded like the coefficients
        # (the batched transform vmaps quants so same-geometry images
        # with different quality stay correct).
        shape = (len(datas), 64)

        def cb(idx):
            imgs = [order[j] for j in range(*idx[0].indices(len(datas)))]
            stacked = np.stack(
                [local[i].quant[comp_index].astype(np.int32) for i in imgs]
            )
            return stacked[(slice(None),) + tuple(idx[1:])]

        return jax.make_array_from_callback(shape, sh, cb)

    quants = tuple(global_quant(c.component_index) for c in geo.components)
    out = _batched_transform(geo)(coeffs, quants)
    jax.block_until_ready(out)

    # Every addressable output shard must match the production
    # single-process decode of that image (another program, so under
    # the device rounding-tie contract).
    checked = 0
    for shard in out.addressable_shards:
        b = shard.index[0]
        for k, img_idx in enumerate([order[j] for j in range(*b.indices(len(datas)))]):
            assert img_idx in local
            got = np.asarray(shard.data)[k]
            expect = np.asarray(
                local_rgb[mine.index(img_idx)]
            )
            rgb_mismatch(got, expect, f"image {img_idx}")
            checked += 1
    assert checked >= 1
    print(f"proc {pid} OK ({checked} images verified)", flush=True)
    """
)


_GLOBAL_API_WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid = int(sys.argv[1]); port = sys.argv[2]
    sys.path.insert(0, sys.argv[3])
    from jpeglibrary_tpu.parallel import distributed
    distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2 and len(jax.devices()) == 4

    import numpy as np
    import jpeglibrary_tpu as jt
    from jpeglibrary_tpu.models.encoder import encode_rgb
    from jpeglibrary_tpu.parallel.distributed import (
        decode_batch_rgb_global, local_batch_block,
    )
    from jpeglibrary_tpu.utils.synthetic import photo
    from jpeglibrary_tpu.utils.tolerance import rgb_mismatch

    rgb0 = photo(120, 200, seed=7)
    base = encode_rgb(rgb0, 85)
    datas = [
        base,
        encode_rgb(rgb0[::-1], 80),
        encode_rgb(rgb0[:, ::-1], 80),
        encode_rgb(np.roll(rgb0, 100, axis=0), 80),
    ]
    out = decode_batch_rgb_global(datas)
    jax.block_until_ready(out)
    # Every addressable shard must match the production single-process
    # DEVICE batch decode of that image (planar CHW), under the device
    # rounding-tie contract: the sharded program is another program.
    from jpeglibrary_tpu.parallel.batch import decode_batch_rgb

    checked = 0
    block = local_batch_block(len(datas))
    local_ref = decode_batch_rgb([datas[i] for i in block])
    for shard in out.addressable_shards:
        lo, hi, _ = shard.index[0].indices(len(datas))
        for k, img_idx in enumerate(range(lo, hi)):
            assert img_idx in block, (pid, img_idx, block)
            got = np.asarray(shard.data)[k]
            expect = np.moveaxis(local_ref[img_idx - block.start], -1, 0)
            rgb_mismatch(got, expect, f"image {img_idx}")
            checked += 1
    assert checked >= 1
    print(f"proc {pid} OK ({checked} images verified)", flush=True)
    """
)


def _run_two_process(worker_src):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", worker_src, str(i), str(port), _REPO],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outputs = []
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            pytest.fail(f"distributed worker {i} timed out")
        outputs.append((p.returncode, out))
    for i, (rc, out) in enumerate(outputs):
        assert rc == 0, f"worker {i} failed:\n{out[-2000:]}"
        assert f"proc {i} OK" in out


def test_two_process_sharded_step_matches_single_device():
    _run_two_process(_WORKER)


def test_two_process_decode_batch_rgb_global():
    """The production multi-host batch API (decode_batch_rgb_global):
    each process scans only its contiguous block, payloads stay on
    their own process's devices, and every addressable output shard is
    bit-exact vs the local single-process decode."""
    _run_two_process(_GLOBAL_API_WORKER)


def test_two_process_real_jpeg_batch_decode():
    """End-to-end multi-process decode of photographic JPEGs: each process
    entropy-decodes its local_batch_indices slice through the
    production pipeline, the batched transform runs on the global
    2-process mesh, and every addressable output shard is bit-exact
    against the local production decode (SURVEY §2.4 comm-backend)."""
    _run_two_process(_REAL_WORKER)
