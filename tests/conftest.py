"""Test harness configuration.

Runs JAX on the CPU backend with 8 virtual devices, so multi-device
sharding logic is exercised without GPUs — the fake-backend testing
capability the reference lacks (SURVEY.md §4). XLA_FLAGS and
JAX_PLATFORMS are read when the backend initializes, so setting them
here, before any jax.devices() call, is early enough.

Tests that only a GPU can run carry the ``gpu`` marker and skip here;
``chip_smoke.py`` covers the same paths on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_ENABLE_X64", "0")
