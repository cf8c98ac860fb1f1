"""A run whose timed path is broken underneath comes out not correct:
the harness's look for a chip skipped (``--device cpu``), the rest of a
run driven at 64x128, patch 32, once for each fault the cell can have (on
one chip there is no exchange between chips to leave out)."""

from __future__ import annotations

import json

import pytest

from benchmark import program, run
from benchmark.tests.small import cli_args


def _line(capsys, cell):
    assert run.main(cli_args(cell)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["oneshot_s2d3d.batched_b64", "iterative_s2d3d.batched_b64"])
def test_an_answer_altered_where_it_is_produced(cell, capsys, monkeypatch):
    depths = program.depths

    def altered(out):
        ds = depths(out)
        d = ds[-1].clone()
        d[0] = d[0].flip(0)  # the first panorama's served depth upside down
        return ds[:-1] + [d]

    monkeypatch.setattr(program, "depths", altered)
    line = _line(capsys, cell)
    assert line["correct"] is False and line["failed"] >= 1


def test_a_step_that_returns_its_state_unchanged(capsys, monkeypatch):
    from omnifusion_torch.training import forward_loss

    def unchanged(state, batch):
        loss, pred = forward_loss(state.model, batch)
        return {"loss": loss.detach(), "pred_mean": pred.detach().mean()}

    monkeypatch.setattr(program, "train_step", unchanged)
    line = _line(capsys, "oneshot_s2d3d.train_b8")
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(capsys, monkeypatch):
    step = program.train_step

    def half(state, batch):
        return step(state, {k: v[: len(v) // 2] for k, v in batch.items()})

    monkeypatch.setattr(program, "train_step", half)
    line = _line(capsys, "oneshot_s2d3d.train_b8")
    assert line["correct"] is False
