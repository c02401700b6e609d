"""One short run of a cell on the card, as the benchmark's command runs it.
Skips on a host without a CUDA card (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH


@pytest.mark.cuda
def test_short_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = os.path.dirname(BENCH)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "d0_serve_b1",
         "--seed", str(2 ** 31 + 9), "--seconds", "2", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, out.stderr[-4000:]
    assert result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"serve_p95_ms", "setup_s"}
