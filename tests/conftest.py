"""Test harness config: run everything on a virtual 8-device CPU mesh.

The platform is pinned both in the environment and in jax's config, in case
jax was imported before this file; XLA_FLAGS is read at backend init, which
is still ahead.  GPU runs go through ``chip_smoke.py``.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# enable float64 on the CPU test backend (the float32 default path keeps
# f32 via explicit dtypes in forms/config; x64 lets oracle-parity tests run
# in real double precision)
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu", "tests must run on the CPU backend"
assert len(jax.devices()) == 8, "tests expect an 8-device virtual CPU mesh"
