"""The port's ``entry.dryrun_multichip(n)`` — the counterpart of
``__graft_entry__.dryrun_multichip`` — on gloo worlds of the CPU: n = 8
takes the 4-D (data, sp, model, ep) mesh with the ring, the MoE, GQA and
packed documents spanning ranks, then the GPipe check over 8 stages; n = 4
takes the default (data, model) mesh. With no device the entry runs on
CUDA, one card per rank, and raises when there are fewer cards.
"""

import math

import pytest
import torch

from tpu_operator_torch.entry import dryrun_multichip


def test_eight_ranks_take_the_4d_mesh(capsys):
    report = dryrun_multichip(8, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip: mesh={'data': 1, 'sp': 2, 'model': 2, 'ep': 2}, loss=")
    assert "pp=8 stages (err_vs_sequential=" in line
    assert report["mesh"] == {"data": 1, "sp": 2, "model": 2, "ep": 2}
    assert math.isfinite(report["loss"]) and report["pipeline"]["ok"]
    assert report["pipeline"]["max_abs_err_vs_sequential"] < 1e-4


def test_four_ranks_take_data_and_model(capsys):
    report = dryrun_multichip(4, device="cpu")
    assert report["mesh"] == {"data": 1, "model": 4}
    assert "pp=4 stages" in capsys.readouterr().out


def test_without_cuda_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(2)


def test_with_too_few_cards_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        dryrun_multichip(2)
