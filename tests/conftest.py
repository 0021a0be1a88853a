"""Test harness: the CPU platform with 8 virtual devices, so sharding tests
run without a multi-device machine (SURVEY.md §4). Run as
``JAX_PLATFORMS=cpu python -m pytest tests/``; the CPU is the default here
too."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)
