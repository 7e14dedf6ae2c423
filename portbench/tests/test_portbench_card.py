"""Tests that need the card: each decides inside itself, and skips
without one."""
import json
import subprocess
import sys

import pytest
import torch

from portbench import harness


def test_card_run_of_a_cell():
    """On the card: one short run of the main cell prints a correct
    line."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the benchmark runs on CUDA only")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "fleet100k-1khz.aligned", "--seed", "3", "--seconds", "2",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
