"""Without a card a run fails and prints no result."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_run_without_a_card_fails_and_prints_no_result(trace):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "map.replica_room0", "--seed", "3000000000", "--seconds", "1",
         "--trace", trace], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    for line in p.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
    assert "busy_s" not in p.stdout and "memory_peak_bytes" not in p.stdout
