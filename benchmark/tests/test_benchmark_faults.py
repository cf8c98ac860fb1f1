"""A run whose timed path is broken underneath comes out not correct:
the harness's look for a chip skipped (``--device cpu``), the rest of a
run driven at 64x128, patch 32, once for each fault the cell can have (on
one chip there is no exchange between chips to leave out)."""

from __future__ import annotations

import json

import pytest

from benchmark import harness, program, run
from benchmark.tests.small import cli_args


def _line(capsys, cell):
    assert run.main(cli_args(cell)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _kind(cell):
    """The program side of the cell's model kind (benchmark/models/)."""
    return program.kind(harness.load_cell(cell).config)


@pytest.mark.parametrize("cell", ["oneshot_s2d3d.batched_b64", "iterative_s2d3d.batched_b64"])
def test_an_answer_altered_where_it_is_produced(cell, capsys, monkeypatch):
    kind = _kind(cell)
    outputs = kind.outputs

    def altered(out):
        ds = outputs(out)
        d = ds[-1].clone()
        d[0] = d[0].flip(0)  # the first panorama's served depth upside down
        return ds[:-1] + [d]

    monkeypatch.setattr(kind, "outputs", altered)
    line = _line(capsys, cell)
    assert line["correct"] is False and line["failed"] >= 1


def test_a_step_that_returns_its_state_unchanged(capsys, monkeypatch):
    from omnifusion_torch.training import forward_loss

    def unchanged(state, batch):
        loss, pred = forward_loss(state.model, batch)
        return {"loss": loss.detach(), "pred_mean": pred.detach().mean()}

    cell = "oneshot_s2d3d.train_b8"
    monkeypatch.setattr(_kind(cell), "train_step", unchanged)
    line = _line(capsys, cell)
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(capsys, monkeypatch):
    cell = "oneshot_s2d3d.train_b8"
    kind = _kind(cell)
    step = kind.train_step

    def half(state, batch):
        return step(state, {k: v[: len(v) // 2] for k, v in batch.items()})

    monkeypatch.setattr(kind, "train_step", half)
    line = _line(capsys, cell)
    assert line["correct"] is False
