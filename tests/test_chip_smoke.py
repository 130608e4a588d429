"""``chip_smoke.py`` on the CPU: its refusals, and its one-GPU phases at toy
sizes (the float64 reference computed in-process)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402

SHT = dict(nside=8, lmax=16, seed=2)
MODELS = (((32, 32), None), ((32, 32), 8))


@pytest.fixture(scope="module")
def reference():
    spec = dict(sht=SHT, models=[dict(shape=s, knots=k, seed=3) for s, k in MODELS])
    return smoke.InProcessReference(spec)


def _last_json(stdout):
    lines = [l for l in stdout.strip().splitlines() if l.strip()]
    try:
        return json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        return None


def test_check_device_refuses_cpu():
    from nifty_tpu.profiling import check_device

    with pytest.raises(RuntimeError, match="no GPU"):
        check_device(jax.devices())


@pytest.mark.parametrize("args", [[], ["--four"]])
def test_script_exits_nonzero_without_gpu(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert _last_json(r.stdout) is None


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300,
    )
    assert r.returncode != 0
    assert _last_json(r.stdout) is None


def test_phase_kernels_toy(reference, capsys):
    smoke.phase_kernels((32, 30), (32, 30), 32, 8, SHT, reference)
    out = capsys.readouterr().out
    for name in ("hartley 32^2", "gather 32^2-exact", "scatter-add 30^2-exact",
                 "knot pull-back", "healpix_synthesis nside 8"):
        assert name in out


def test_phase_model_toy(reference, capsys):
    smoke.phase_model(MODELS, (((64, 32), 8),), reference)
    out = capsys.readouterr().out
    assert "metric - L(R(.)) 32x32_exact" in out
    assert "metric 64x32_knots8: finite" in out


def test_compare_rejects_wrong_results():
    want = np.linspace(1.0, 2.0, 10)
    smoke.compare("exact", want, want, 0.0)
    with pytest.raises(smoke.SmokeFailure, match="relative error"):
        smoke.compare("dropped term", want * (1 + 1e-3), want, 1e-5)
    with pytest.raises(smoke.SmokeFailure, match="non-finite"):
        smoke.compare("nan", np.full(10, np.nan), want, 1.0)


def test_host_reference_child_matches_in_process(reference):
    """The CPU-only child computes what the in-process reference does."""
    spec = dict(sht=SHT, models=[dict(shape=(32, 32), knots=8, seed=3)])
    child = smoke.HostReference(spec)
    try:
        got = child.result(timeout=600)
    finally:
        child.close()
    want = reference.result()
    assert sorted(got) == sorted(k for k in want if not k.startswith("32x32_exact"))
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-12, atol=1e-12)
