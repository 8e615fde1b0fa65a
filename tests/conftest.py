"""Test configuration: force a virtual 8-device CPU mesh.

Multi-device sharding is tested on virtual CPU devices
(xla_force_host_platform_device_count), per the project test strategy
(SURVEY.md §4.5); CPU runs are also far faster for the many small test
workloads. Tests that need the GPU carry the ``chip`` marker and run
their work in a child process that sees the card.
"""

import os

# Force CPU, overwriting any setting: on a machine with a GPU, JAX would
# otherwise take the card, the virtual 8-device mesh would not exist,
# and every test worker would reserve most of the card's memory.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib

import pytest

ASSETS = pathlib.Path("/root/reference/tests/Assets")


@pytest.fixture(scope="session")
def assets_dir() -> pathlib.Path:
    if not ASSETS.is_dir():
        pytest.skip("reference asset directory unavailable")
    return ASSETS


@pytest.fixture(scope="session")
def photos():
    """Seeded photographic-like RGB images of two geometries, shared by
    the device-path tests in place of reference assets."""
    from jpeglibrary_tpu.utils.synthetic import photo

    return [photo(256, 384, seed=1), photo(120, 200, seed=2)]


@pytest.fixture(scope="session")
def photo_jpegs(photos):
    """``photos`` encoded q85 4:2:0 with optimized Huffman tables."""
    import jpeglibrary_tpu as jt

    return [jt.encode_rgb(p, 85, optimize_coding=True) for p in photos]
