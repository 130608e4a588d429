"""``chip_smoke.py --four``'s comparisons on four virtual CPU devices
(``conftest.py`` provides eight), at toy sizes."""

import os
import sys

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402


def _four():
    devices = jax.devices()[:4]
    assert len(devices) == 4
    return devices


def test_four_sample_sharded_matches_one_device(capsys):
    smoke.four_sample_sharded(_four(), (32, 32), None, n_samples=4)
    assert "sample-sharded geoVI 32x32_exact over 4 devices" in capsys.readouterr().out


def test_four_field_sharded_matches_one_device(capsys):
    smoke.four_field_sharded(_four(), (32, 32), 8, n_samples=2)
    out = capsys.readouterr().out
    assert "cfxi shards [(8, 32)] on 4 devices" in out


def test_four_pencil_hartley_matches_hartley(capsys):
    smoke.four_hartley(_four(), 32)
    assert "sharded_hartley2 32^2 on fx=4" in capsys.readouterr().out
