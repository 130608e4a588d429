"""≥10⁸-dof domain-decomposed inference step on the virtual 8-device mesh.

The criterion for integrated field sharding: a 10240²
(1.05·10⁸ parameter) correlated field runs forward, metric, CG sampling,
and a Newton-CG KL step domain-decomposed over the mesh with per-device
arrays of O(N/p).  float32 throughout.  Gated behind
``NIFTY_TPU_LARGE=1`` — it needs ~20 GB RAM and minutes of (virtual-CPU)
wall time; run manually or in a nightly lane.  A 1024² ungated smoke
variant covers the same code path in CI.
"""

import os

import jax
import numpy as np
import pytest
from jax import numpy as jnp
from jax import random
from jax.sharding import Mesh

import nifty_tpu as nt

LARGE = os.environ.get("NIFTY_TPU_LARGE", "") == "1"


def _mesh():
    return Mesh(np.asarray(jax.devices()), ("fx",))


def _run_step(shape, *, knots=64, remat=False, map="vmap"):
    from functools import partial

    from nifty_tpu.optimize_kl import _kl_met, _kl_vg

    mesh = _mesh()
    with jax.enable_x64(False):
        cfm = nt.CorrelatedFieldMaker("cf")
        cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
        cfm.add_fluctuations(
            shape,
            distances=1.0 / shape[0],
            fluctuations=(1.0, 5e-1),
            loglogavgslope=(-3.0, 2e-1),
            flexibility=(1e0, 2e-1),
            n_mode_knots=knots,
        )
        cf = cfm.finalize(field_mesh=mesh)
        fwd = nt.RematModel(cf) if remat else cf
        from jax.sharding import NamedSharding, PartitionSpec

        # the data array must be born sharded — a replicated 4.3 GB
        # constant per virtual device OOMs the host at 10⁹ dof
        data_sharding = NamedSharding(
            mesh, PartitionSpec("fx", *(None,) * (len(shape) - 1))
        )
        data = jax.jit(
            lambda: jnp.zeros(shape, jnp.float32),
            out_shardings=data_sharding,
        )()
        lh = nt.Gaussian(data, noise_std_inv=lambda x: 3.0 * x).amend(fwd)
        pos = nt.Vector(
            jax.jit(cf.init, out_shardings=cf.position_sharding())(
                random.PRNGKey(0)
            )
        )
        keys = random.split(random.PRNGKey(1), 1)

        def step(lh, pos, keys):
            draw = partial(
                nt.draw_linear_residual,
                lh,
                cg=nt.static_cg,
                cg_kwargs=dict(maxiter=3, miniter=3, resnorm=-1.0),
            )
            smpls, _ = jax.vmap(draw, in_axes=(None, 0))(pos, keys)
            smpls = jax.tree_util.tree_map(
                lambda s: jnp.concatenate([s, -s], axis=0), smpls
            )
            samples = nt.Samples(pos=pos, samples=smpls, keys=keys)
            res = nt.static_newton_cg(
                x0=pos,
                fun_and_grad=partial(
                    _kl_vg, lh, primals_samples=samples, map=map
                ),
                hessp=partial(
                    _kl_met, lh, primals_samples=samples, map=map
                ),
                maxiter=1,
                cg_kwargs=dict(maxiter=2, miniter=2, resnorm=-1.0),
            )
            return res.x, res.fun

        jstep = jax.jit(step)
        new_pos, energy = jstep(lh, pos, keys)
        jax.block_until_ready(new_pos)
        try:
            # same HLO → hits the in-process executable cache; stats only
            ma = jstep.lower(lh, pos, keys).compile().memory_analysis()
            n_dev = len(jax.devices())
            print(
                f"memory analysis {shape}: args "
                f"{ma.argument_size_in_bytes/2**30:.2f} GiB, temp "
                f"{ma.temp_size_in_bytes/2**30:.2f} GiB, output "
                f"{ma.output_size_in_bytes/2**30:.2f} GiB "
                f"(per-device temp ≈ "
                f"{ma.temp_size_in_bytes/n_dev/2**30:.2f} GiB)",
                flush=True,
            )
        except Exception as e:  # noqa: BLE001 - diagnostics only
            print(f"memory analysis unavailable: {e!r}", flush=True)
        import resource

        peak_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        print(
            f"peak host RSS {shape}: {peak_gib:.2f} GiB "
            f"(≈ {peak_gib / len(jax.devices()):.2f} GiB per virtual device)",
            flush=True,
        )
        xi = new_pos.tree["cfxi"]
        assert xi.dtype == jnp.float32
        assert np.isfinite(float(energy))
        # genuinely domain-decomposed: the excitation leaf is row-sharded
        # and each shard holds 1/p of the rows
        assert xi.sharding.spec[0] == "fx"
        n_dev = len(jax.devices())
        shard_rows = {s.data.shape[0] for s in xi.addressable_shards}
        assert shard_rows == {shape[0] // n_dev}
        return float(energy)


def test_field_sharded_vi_step_smoke():
    _run_step((1024, 512), knots=16)


@pytest.mark.skipif(not LARGE, reason="set NIFTY_TPU_LARGE=1 (needs ~20 GB, minutes)")
def test_field_sharded_vi_step_1e8_dof():
    shape = (10240, 10240)  # 1.05e8 parameters
    _run_step(shape, knots=64)


def test_field_sharded_vi_step_3d_smoke():
    """3-D correlated field, domain-decomposed — the 10⁹-dof code path
    at CI size."""
    _run_step((128, 64, 16), knots=8)


@pytest.mark.skipif(
    not LARGE, reason="set NIFTY_TPU_LARGE=1 (needs ~65 GB, ~25 min)"
)
def test_field_sharded_vi_step_5e8_dof():
    """5.4·10⁸-parameter 3-D field VI step.  Memory model (measured, see
    docs/design.md "Measured memory model"): host RSS ≈ 123 B/dof + 1 GiB
    with ``map="smap"`` (sequential sample map) — ≈63 GiB here.  Run with
    --xla_force_host_platform_device_count=2 (total RSS is invariant in
    the device count, but fewer devices = fewer serial rendezvous)."""
    _run_step((8192, 8192, 8), knots=64, map="smap")


@pytest.mark.skipif(
    not LARGE, reason="set NIFTY_TPU_LARGE=1 (needs ~120 GB, ~an hour)"
)
def test_field_sharded_vi_step_1e9_dof():
    """The BASELINE.md north star: a ≥10⁹-parameter 3-D correlated field
    runs a full domain-decomposed VI step (sampling CG + Newton-CG KL
    step). 8192·8192·16 = 1.074e9 parameters; predicted ≈124 GiB host
    RSS per the measured model in docs/design.md — only fits hosts with
    ≳128 GB (virtual-device CPU execution materializes every device's
    shard in one address space; real devices need only the
    per-device share, see docs/design.md)."""
    _run_step((8192, 8192, 16), knots=64, map="smap")
