"""Test config: force the CPU backend with 8 virtual devices so the
multi-device sharding tests run anywhere (SURVEY §4: multi-host tests on
fake meshes).  Tests that need a GPU carry the `gpu` marker and skip
here (tests/test_gpu.py).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
