"""Device numerics settings: every float32 matrix product on the device
path states full float32 precision (a GPU would otherwise run it in
TF32), and the persistent compile cache lives where it is told to."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO = pathlib.Path(__file__).resolve().parent.parent


def _dot_precisions(jaxpr):
    """Precision params of every dot_general in a jaxpr, sub-jaxprs
    (jit, vmap bodies, custom rules) included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    out.extend(_dot_precisions(inner))
    return out


def _scaled_plane():
    from jpeglibrary_tpu.ops import decode_stage

    coeffs = np.zeros((2, 3, 64), np.int16)
    quant = np.ones(64, np.int32)
    return jax.make_jaxpr(
        lambda c, q: decode_stage.component_plane_scaled(c, q, 128, 1, 1, 4, 6, 2, xp=jnp)
    )(coeffs, quant)


def _scaled_program():
    import jpeglibrary_tpu as jt
    from jpeglibrary_tpu.models.decoder import JpegDecoder
    from jpeglibrary_tpu.ops.pipeline import jitted_transform_mcu2_inner

    rgb = np.full((32, 48, 3), 100, np.uint8)
    dec = JpegDecoder()
    dec.set_input(jt.encode_rgb(rgb, 75))
    res = dec.decode(sparse_direct=True)
    quants = np.stack([res.quant[c.component_index] for c in res.geometry.components])
    fn = jitted_transform_mcu2_inner(res.geometry, "rgb8", "duplicate", 4)
    return jax.make_jaxpr(fn)(res.packed_mcu2, quants.astype(np.int32))


def _device_fdct():
    from jpeglibrary_tpu.ops import encode_stage

    fwd = encode_stage.jitted_forward(((1, 1, 1, 1),), 2, 2, 128.0)
    return jax.make_jaxpr(fwd)((np.zeros((16, 16), np.uint8),), np.ones((1, 64), np.int32))


def _full_step():
    sys.path.insert(0, str(REPO))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    return jax.make_jaxpr(fn)(*args)


def _gpu_idct_kernel():
    import functools

    from jpeglibrary_tpu.ops import idct_kernel

    fn = functools.partial(idct_kernel.dequantize_idct_shift, level_shift=128, interpret=True)
    return jax.make_jaxpr(fn)(np.zeros((4, 64), np.int16), np.ones(64, np.int32))


@pytest.mark.parametrize(
    "build", [_scaled_plane, _scaled_program, _device_fdct, _full_step, _gpu_idct_kernel],
    ids=["scaled_plane", "scaled_program", "device_fdct", "full_step", "gpu_idct_kernel"],
)
def test_device_matmuls_are_highest_precision(build):
    precisions = _dot_precisions(build().jaxpr)
    assert precisions, "no matrix product found"
    for p in precisions:
        assert p is not None and all(x == jax.lax.Precision.HIGHEST for x in p), p


_CACHE_PROBE = """
import jax
import jpeglibrary_tpu as jt
jax.default_backend = lambda: "gpu"  # placement rule of a GPU process
jt.enable_compile_cache()
print(jax.config.jax_compilation_cache_dir)
"""


@pytest.mark.parametrize("from_env", [True, False], ids=["env", "checkout"])
def test_compile_cache_placement(tmp_path, from_env):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = str(REPO / ".jax_cache")
    if from_env:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == want
