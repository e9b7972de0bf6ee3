"""Test configuration: run every test on a virtual 8-device CPU mesh.

Sharded code paths are validated on 8 virtual CPU devices (the
JAX-sanctioned substitute for several cards); ``chip_smoke.py --dist-ba``
runs the same path on four GPUs. Tests marked ``gpu`` run their checks in
a child process that may open the card, and skip where none is visible.
"""

import os
import subprocess

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")


@pytest.fixture
def gpu_env():
    """Environment for a child process that runs on the GPU; skips the
    test when nvidia-smi lists no GPU. The test process itself stays
    pinned to the CPU, so the child is the card's only JAX process."""
    try:
        q = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                           text=True, timeout=60)
        found = q.returncode == 0 and "GPU" in q.stdout
    except (OSError, subprocess.TimeoutExpired):
        found = False
    if not found:
        pytest.skip("no NVIDIA GPU visible (nvidia-smi lists none)")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env
