import os
import sys

# Force CPU with a virtual 8-device mesh for sharding tests, through the
# environment and the config both (a preset JAX_PLATFORMS is overwritten).
# Tests marked `gpu` are the exception: they run in a child process that
# selects the GPU itself (tests/test_gpu_hw.py).
os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
