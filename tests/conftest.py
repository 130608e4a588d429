import os

# Run the test-suite on a virtual 8-device CPU mesh so multi-device sharding
# paths are exercised without accelerators (same trick as the reference's
# demos/re/a_demo_multi-gpu.py:20-23).
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_collective_call_terminate_timeout_seconds" not in flags:
    # virtual devices execute near-serially on one host: at ≥1e8-dof
    # sizes the per-device work before an all-to-all exceeds the 40 s
    # default rendezvous termination timeout
    flags = (
        flags
        + " --xla_cpu_collective_call_warn_stuck_timeout_seconds=600"
        + " --xla_cpu_collective_call_terminate_timeout_seconds=7200"
    ).strip()
os.environ["XLA_FLAGS"] = flags

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
