"""Tests that need a GPU (marker ``chip``).

Run them on the card with ``python -m pytest tests -m chip``; elsewhere they
skip.  Whether a card is present is decided inside the ``gpu`` fixture, by a
child process that stays off JAX, never while this module is imported.  The
test process itself runs on the CPU (tests/conftest.py), so the card is left
to the child that the test starts.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def gpu():
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True).returncode:
        pytest.skip("no NVIDIA GPU on this machine")


@pytest.mark.chip
def test_cycle_numerics_on_the_card(gpu):
    """chip_smoke.py phase 3: the float32 W-cycle on the card against the
    float64 host reference at 255^2 and 63^3."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "chip_smoke.py", "--phases", "3"],
                       cwd=str(REPO), env=env, capture_output=True, text=True,
                       timeout=1200)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["device"]["platform"] == "gpu"
