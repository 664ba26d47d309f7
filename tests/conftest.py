"""Test configuration: force CPU with 8 virtual devices so sharding/mesh tests
run anywhere (mirrors the driver's multi-chip dry-run environment).

Note: jax may already be imported when this runs (pytest plugin autoload), so
setting JAX_PLATFORMS alone is not enough — update the live config too. This
works as long as no backend has been initialized yet.
"""

import os

# OLMOASR_TEST_TPU=1 keeps the real backend so TPU-only suites (the decode
# flag-matrix parity test) can run on a chip: `OLMOASR_TEST_TPU=1 pytest
# tests/test_decode_flag_matrix.py`. Default stays the 8-device CPU mesh.
if os.environ.get("OLMOASR_TEST_TPU", "0") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (kernels of olmoasr_tpu_torch); skips without one",
    )
