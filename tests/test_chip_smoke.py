"""chip_smoke.py: the GPU smoke run's refusal without a card, and each
of its phases at a tiny size on the CPU (the same code the card runs,
through the ``Sizes`` argument; ``main`` itself accepts only a GPU)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

TINY = chip_smoke.Sizes(
    side=96, batch=3, batch_hw=(40, 56), fdct_side=64, step_batch=2,
    step_blocks=8, scan_side=48, stripe_rows=2, reps=2,
)


@pytest.fixture(scope="module")
def inputs():
    return chip_smoke.make_inputs(TINY)


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("phase", ["decode", "programs", "scaled", "stripes"])
def test_decode_phases_tiny(inputs, phase):
    fn = getattr(chip_smoke, f"phase_{phase}")
    if phase in ("programs", "scaled"):
        fn(inputs)
    else:
        fn(inputs, TINY)


@pytest.mark.parametrize("phase", ["fdct", "full_step", "device_scan"])
def test_standalone_phases_tiny(phase):
    getattr(chip_smoke, f"phase_{phase}")(TINY)


def test_four_device_phase_on_virtual_devices(inputs):
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    chip_smoke.phase_four(inputs, 4)


@pytest.fixture
def gpu_env():
    """Environment for a child process that may take the GPU; skips
    where the machine has none."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no GPU on this machine (nvidia-smi not found)")
    return {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}


@pytest.mark.chip
def test_chip_smoke_on_card(gpu_env):
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        cwd=REPO, env=gpu_env, capture_output=True, text=True, timeout=1200,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
