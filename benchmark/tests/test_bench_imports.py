"""The import check compares whole top-level names: the port's name begins
with the JAX package's and passes."""

import subprocess
import sys

from benchmark import harness


def test_forbidden_by_whole_top_level_name():
    mods = ["prosody_control_french_tts_tpu_torch", "prosody_control_french_tts_tpu_torch.models.llm", "jaxtyping",
            "jax", "jaxlib.xla_client", "flax.linen", "prosody_control_french_tts_tpu", "prosody_control_french_tts_tpu.models"]
    assert harness.forbidden_loaded(mods) == ["flax.linen", "jax", "jaxlib.xla_client", "prosody_control_french_tts_tpu",
                                              "prosody_control_french_tts_tpu.models"]


def test_the_driver_and_the_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import harness; "
            "d = harness.driver({'driver': 'train'}); "
            "import prosody_control_french_tts_tpu_torch.models.training, prosody_control_french_tts_tpu_torch.ops.fused_ce; "
            "from benchmark import calibrate, faults; print(harness.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cascade_a.train", "--seed", "2147483649",
                          "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == "", (out.returncode, out.stdout)
