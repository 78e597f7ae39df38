"""The controls and the faults: the reference put in the program's place
one precision below the configuration's, or with a task left out, has to
come out as not correct through a run's own comparison, while the
program's own run stays correct.  On the host at a small size;
``python3 -m portbench.control`` reads the same at full size on the
card."""

import subprocess
import sys

import pytest
import torch

from portbench import control, spec

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["gemm16k.lowered", "potrf16k.lowered"])
@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_controls_and_faults_fail_and_program_passes(bench, cell, seed):
    c = spec.cell(bench, cell)
    cfg = {**spec.config(bench, c["config"]), "N": 512, "nb": 64}
    kind = spec.kind(cfg["kind"])
    runs = {r["run"]: r for r in
            control.readings(bench, cell, seed, CPU, 0.2, cfg=cfg)}
    assert set(runs) == {"program", *kind.CONTROLS, *kind.FAULTS}
    assert runs["program"]["correct"] is True
    for name in (*kind.CONTROLS, *kind.FAULTS):
        r = runs[name]
        assert r["correct"] is False, (name, r)
        assert any(line.endswith("FAILED") for line in r["lines"])


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the first cell on the card: the last line is the
    contract's object, correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the cell runs on the card only")
    import json
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", "gemm16k.lowered",
         "--seed", "5", "--seconds", "2", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
