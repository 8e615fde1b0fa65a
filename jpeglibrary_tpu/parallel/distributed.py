"""Multi-host scaling hooks.

The reference is single-process (SURVEY.md §2.4); this framework scales
across hosts with jax.distributed + the same mesh programs:

- each host entropy-decodes its shard of the image batch locally (the
  host stages are embarrassingly parallel across images),
- the sharded device programs (`parallel.sharding.make_sharded_full_step`,
  batched transforms) run SPMD over the global mesh, with the only
  cross-host traffic being the encoder/optimizer histogram all-reduce
  (a 17-element psum) — DCN-negligible,
- batch-to-host assignment follows `jax.process_index()`.

There is no multi-host hardware in this environment; the mesh program
itself is validated on N virtual devices (tests/test_parallel.py and
the driver's multi-chip dry run).
"""

from __future__ import annotations

from typing import Optional, Sequence


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed (no-op for single-process runs)."""
    import jax

    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_global_mesh(*, stripe: int = 1):
    """A ('data', 'stripe') mesh over all devices of all processes."""
    from .sharding import make_mesh

    return make_mesh(None, stripe=stripe)


def local_batch_indices(n_images: int) -> Sequence[int]:
    """The slice of a global image batch this host should scan: images
    are striped over processes so every host's entropy-decode load is
    balanced regardless of per-image cost."""
    import jax

    return range(jax.process_index(), n_images, jax.process_count())


def local_batch_block(n_images: int) -> range:
    """The CONTIGUOUS block of a global batch owned by this process
    under a P('data') sharding (device d holds batch slice
    [d*B/D, (d+1)*B/D) and each process's devices are consecutive) —
    the assignment :func:`decode_batch_rgb_global` scans by."""
    import jax

    per = n_images // jax.process_count()
    p = jax.process_index()
    return range(p * per, (p + 1) * per)


def decode_batch_rgb_global(datas: Sequence[bytes], *, scan_workers=None):
    """Multi-process batch decode on the global device mesh.

    Every process entropy-decodes ONLY its :func:`local_batch_block`
    slice (the host stage is embarrassingly parallel across hosts); the
    per-image sparse payloads become ONE global jax.Array sharded
    P('data') with each image resident on its own process's devices
    (zero cross-host payload traffic — the only collective is a tiny
    allgather agreeing on the padded payload width); the fused device
    transform then runs SPMD over the global mesh.

    Returns the global device-resident RGB batch ([B, 3, H, W] uint8,
    planar per image). Requirements: all images share one geometry
    (same dimensions/sampling — the serving-batch contract) and
    ``len(datas)`` is divisible by the global device count.

    Single-process runs degrade to the local batch path's semantics
    (the mesh is just this process's devices)."""
    import jax
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ..native import scanner as native_scanner
    from .batch import _batched_transform_delta, _stacked_quants, scan_images

    devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n_dev = len(devices)
    n = len(datas)
    if n % n_dev != 0:
        raise ValueError(
            f"global batch of {n} images must divide the {n_dev} devices"
        )
    mesh = Mesh(np.array(devices), ("data",))

    block = local_batch_block(n)
    results = scan_images([datas[i] for i in block], max_workers=scan_workers)
    geometry = results[0].geometry
    if any(r.geometry != geometry for r in results[1:]):
        raise ValueError("decode_batch_rgb_global needs one shared geometry")
    quants = _stacked_quants(results, geometry)

    local_v2 = all(r.packed_mcu2 is not None for r in results)
    # Branch agreement must be GLOBAL: a process whose image declined
    # the v2 packer would otherwise allgather a pack width where the
    # others expect an AC bucket, and the processes would then dispatch
    # different SPMD programs on one mesh (mismatched collectives ->
    # distributed hang). One extra one-int allgather settles it.
    all_v2 = bool(
        multihost_utils.process_allgather(
            np.asarray([1 if local_v2 else 0], dtype=np.int64)
        ).min()
    )
    if all_v2:
        # v2 split-stream wire (0.4-0.6x the v1 bytes — the shard
        # transfer is each process's dominant device cost): agree on
        # one AC bucket via the same one-int allgather, re-bucket the
        # local payloads to it (stream offsets move with Bn), and run
        # the vmapped v2 transform SPMD over the global mesh.
        bpm = sum(c.h * c.v for c in geometry.components)
        nb = geometry.mcus_per_line * geometry.mcus_per_column * bpm
        bns = [
            native_scanner.v2_payload_bn(r.packed_mcu2, nb) for r in results
        ]
        bn = int(
            multihost_utils.process_allgather(
                np.asarray([max(bns)], dtype=np.int64)
            ).max()
        )
        padded = np.stack(
            [
                native_scanner.rebucket_v2_payload(r.packed_mcu2, nb, bn)
                for r in results
            ]
        )
        width = padded.shape[1]
        sh = NamedSharding(mesh, P("data"))
        base = block.start

        def payload2_cb(idx):
            rows = idx[0].indices(n)
            return padded[rows[0] - base : rows[1] - base][
                (slice(None),) + tuple(idx[1:])
            ]

        def quants2_cb(idx):
            rows = idx[0].indices(n)
            return quants[rows[0] - base : rows[1] - base][
                (slice(None),) + tuple(idx[1:])
            ]

        from .batch import _batched_mcu_transform2

        payload = jax.make_array_from_callback((n, width), sh, payload2_cb)
        qglob = jax.make_array_from_callback(
            (n,) + quants.shape[1:], sh, quants2_cb
        )
        return _batched_mcu_transform2(geometry, 8, mesh)(payload, qglob)

    packs = [
        native_scanner.pack_sparse(
            [r.coefficients[c.component_index] for c in geometry.components]
        ).reshape(-1)
        for r in results
    ]
    local_max = max(p.shape[0] for p in packs)
    width = int(
        multihost_utils.process_allgather(
            np.asarray([local_max], dtype=np.int64)
        ).max()
    )
    padded = np.zeros((len(packs), width), dtype=np.int16)
    for j, p in enumerate(packs):
        padded[j, : p.shape[0]] = p

    sh = NamedSharding(mesh, P("data"))
    base = block.start

    def payload_cb(idx):
        rows = idx[0].indices(n)
        return padded[rows[0] - base : rows[1] - base][
            (slice(None),) + tuple(idx[1:])
        ]

    def quants_cb(idx):
        rows = idx[0].indices(n)
        return quants[rows[0] - base : rows[1] - base][
            (slice(None),) + tuple(idx[1:])
        ]

    payload = jax.make_array_from_callback((n, width), sh, payload_cb)
    qglob = jax.make_array_from_callback((n,) + quants.shape[1:], sh, quants_cb)
    return _batched_transform_delta(geometry, 8, mesh)(payload, qglob)
