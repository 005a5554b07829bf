"""On the card: each committed cell at its own size, a short window. A
sound run comes out correct, and the control (the reference computed
from float8 products, judged in place of the served tokens) comes out
not correct.

    python -m pytest --noconftest -m cuda gpubench/tests/test_gpubench_card.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(cell, seed, control=None):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cmd = [sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
           str(seed), "--seconds", "10", "--trace", "0"]
    if control:
        cmd += ["--control", control]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=900, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell, 2 ** 34 + 11)
    assert out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out = _run(cell, 2 ** 34 + 12, control="fp8")
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
