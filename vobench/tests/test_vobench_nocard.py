"""Without a CUDA device the run command measures nothing: it exits
non-zero and prints no result."""

import subprocess
import sys

import pytest
import torch

from vobench.tests.tiny import ROOT


@pytest.mark.parametrize("workload", ["ms_eval", "ss_eval", "ms_train"])
def test_run_without_a_card_exits_nonzero(workload):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the command would measure")
    p = subprocess.run([sys.executable, "-m", "vobench.run", "--workload",
                        workload, "--seed", "3000000000", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout
