"""Exhaustive golden sweep: EVERY committed `.high.png`/`.low-diff.png`
fixture pair in the reference asset tree must decode bit-exactly —
the complete version of the per-mode golden tests, so no fixture can
silently fall out of coverage."""

import pathlib

import pytest

import jpeglibrary_tpu as jt
from jpeglibrary_tpu.utils.fixtures import load_expected_buffer

ASSETS = pathlib.Path("/root/reference/tests/Assets")
FIXTURES = sorted(str(p)[: -len(".high.png")] for p in ASSETS.rglob("*.high.png"))


def test_fixture_inventory_complete(assets_dir):
    assert len(list(assets_dir.rglob("*.high.png"))) == 17


@pytest.mark.parametrize(
    "asset", FIXTURES, ids=[pathlib.Path(f).name for f in FIXTURES]
)
def test_golden_bit_exact(asset):
    result = jt.decode(open(asset, "rb").read())
    out = result.to_uint16_extended()
    expected = load_expected_buffer(asset, out.shape[-1])[..., : out.shape[-1]]
    assert (out == expected).all()
