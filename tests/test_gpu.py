"""GPU correctness lane: ``chip_smoke.py``'s phases on a real card.

Every other test runs on the CPU (``conftest.py`` forces it in this
process), so the lane runs the smoke in a child process that may open the
card, and checks its exit status and last line.  It skips where no card is
found.  On a machine with a GPU::

    python -m pytest -m gpu tests/test_gpu.py -s
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpu_env():
    """Environment for a child process on the card; skips without one."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True).returncode:
        pytest.skip("no NVIDIA GPU on this machine")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_env):
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=gpu_env, cwd=REPO, timeout=1200,
    )
    print(r.stdout)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
