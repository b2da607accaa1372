"""Test configuration: force the CPU backend with 8 virtual devices so
sharding tests run without real multi-device hardware. Conftest imports
before any test initializes a backend. Tests marked ``chip`` reach the
GPU through a subprocess of their own (see tests/test_chip_smoke.py).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.default_backend() == "cpu"
assert jax.device_count() == 8
