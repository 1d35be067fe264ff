"""Without a card the command fails with a message and prints no
result; it never falls back to the CPU."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "lg256.one_graph",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr
