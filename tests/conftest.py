"""Test configuration: JAX on the CPU with 8 virtual devices, unless the
environment already names a platform (a GPU run sets JAX_PLATFORMS=cuda
and runs the `gpu`-marked tests).

Sharding tests run on a virtual 8-device CPU mesh per JAX's standard
recipe; the XLA flag must be set before JAX initializes a backend.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
