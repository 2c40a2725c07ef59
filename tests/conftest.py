"""Test env: the CPU backend with 8 virtual devices, so the device stages and
the sharded mesh paths run without a GPU. Must run before jax is imported
anywhere: JAX reads these variables when its backends start."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the device stages run on the CPU only when JAX_PLATFORMS asks for it
# (pgrc/device.py); unit tests never use a GPU
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_ENABLE_X64"] = "1"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running integration tests (multi-process dryruns)")
