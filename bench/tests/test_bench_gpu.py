"""Each cell run on a card, briefly (``python -m pytest -m gpu bench/tests``)."""
import json
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["gcn-papers100m.coop", "rgcn-mag240m.coop",
                                  "gcn-papers100m.indep"])
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", cell, "--seed",
                          "2147483701", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu", out
