"""Whole runs of each cell at a tiny size on the CPU (the harness's look
for a card skipped): the program's outputs pass the check; the reference
rounded to float8 in the program's place (the control) and the timed path
broken underneath each read not correct."""

import time

import pytest
import torch

from benchmark import harness
from tiny import tiny_run

CELLS = [w["name"] for w in harness.benchmark_json()["workloads"]]


def _line(run):
    line = harness.execute(run, time.perf_counter())
    assert line is not None
    return line


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes(cell):
    line = _line(tiny_run(cell))
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    line = _line(tiny_run(cell, control="fp8"))
    assert not line["correct"], line["checks"]


def _flip(fn):
    def broken(*a, **k):
        out = fn(*a, **k)
        return torch.flip(out, dims=[-1])
    return broken


def test_altered_stream_maps_fail(monkeypatch):
    from cp360_tpu_torch.pipelines import stream

    monkeypatch.setattr(stream, "window_infer_from_frames", _flip(stream.window_infer_from_frames))
    assert not _line(tiny_run("r50-stream"))["correct"]


def test_train_step_that_changes_nothing_fails(monkeypatch):
    from cp360_tpu_torch.train import loop

    make = loop.make_train_step

    def frozen(cfg, model, opt, *a, **k):
        step = make(cfg, model, opt, *a, **k)

        def run(seq, flows):
            keep = [p.detach().clone() for p in model.parameters()]
            out = step(seq, flows)
            with torch.no_grad():
                for p, q in zip(model.parameters(), keep):
                    p.copy_(q)
            return out
        return run

    monkeypatch.setattr(loop, "make_train_step", frozen)
    line = _line(tiny_run("r50-train"))
    assert not line["correct"] and line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_step_on_half_the_batch_fails(monkeypatch):
    from cp360_tpu_torch.train import loop

    make = loop.make_loss_fn

    def half(cfg, model, *a, **k):
        fn = make(cfg, model, *a, **k)

        def loss_fn(seq, flows):
            b = seq.shape[0] // 2
            loss, parts = fn(seq[:b], flows[:b])
            return loss * (seq.shape[0] / b), parts
        return loss_fn

    monkeypatch.setattr(loop, "make_loss_fn", half)
    assert not _line(tiny_run("r50-train"))["correct"]
