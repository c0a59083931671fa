"""Without a card the benchmark fails and prints no result: it never
falls back to the CPU."""
import subprocess
import sys

import pytest

from conftest import ROOT


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(["--workload", "dmc-n128-bare", "--seed", "7",
                     "--seconds", "1", "--trace", "0"]) != 0
    out, err = capsys.readouterr()
    assert out == ""
    assert "CUDA device" in err


def test_no_card_from_the_command_line():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "vmc-n64-sk",
         "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_the_result_refuses_forbidden_modules(monkeypatch):
    import run

    import phd_qmclib_torch  # noqa: F401

    # The port's name begins with the JAX package's: compared whole.
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "dmc-n128-bare",
         "--seed", str(2 ** 31 + 11), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    import json

    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
