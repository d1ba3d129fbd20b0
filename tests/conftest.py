"""Test harness: force CPU JAX with a virtual 8-device mesh so multi-chip
sharding paths compile and execute without TPU hardware (SURVEY.md §4)."""

import os
import sys
from pathlib import Path

# Force CPU for tests even when the session environment points at a TPU:
# the suite validates numerics and sharding on a virtual 8-device CPU mesh
# (set PCFT_TEST_TPU=1 to run against real hardware). jax may already be
# imported by a pytest plugin, so update its config too — env vars alone
# are read at jax import time.
if not os.environ.get("PCFT_TEST_TPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

# Persistent compile cache (same dir bench.py uses): XLA compiles dominate
# suite wall-clock on this 1-vCPU host — a warm cache cuts the full run by
# minutes. Entries are keyed by HLO + platform + compiler options, so CPU
# test programs never collide with the TPU bench entries.
jax.config.update(
    "jax_compilation_cache_dir", str(Path(__file__).resolve().parent.parent / ".jax_cache")
)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def corpus_wavs():
    """The reference's bundled fixture corpus, if present (10 wavs, 44.1 kHz,
    ≈162 s — Data/voice/records/audio)."""
    d = Path("/root/reference/Data/voice/records/audio")
    if not d.is_dir():
        pytest.skip("bundled corpus not available")
    return sorted(d.glob("*.wav"), key=lambda p: int("".join(filter(str.isdigit, p.stem))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the PyTorch port's kernels); skips without one"
    )
