"""A cell's whole run on a CUDA card (skips without one): the last line is
the result, correct, with every end-to-end metric of the cell."""

import json
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["cascade_a.train"])
def test_cell_runs_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed", "2147483999", "--seconds", "4",
                          "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {m["name"] for m in harness.find_cell(workload)["end_to_end"]}
