"""``chip_smoke.py``'s geoVI phase at a toy size on the CPU (its own file:
the compile dominates, so it runs beside the other smoke tests)."""

import os
import sys

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402


def test_phase_inference_toy():
    # float32, as on the card (the test session enables float64)
    with jax.enable_x64(False):
        energies = smoke.phase_inference((48, 48), None, n_samples=2, n_iterations=3)
    assert len(energies) == 3 and energies[-1] < energies[0]
