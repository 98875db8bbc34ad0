"""Each fault a cell can have, planted under a run at the program's
reduced size on the CPU, turns ``correct`` false under the cell's own
limits; a sound run stays correct; the control reads far above the
program (the chip readings that set the limits are in PERF.md)."""

import pytest
import torch

from perfbench import control
from perfbench.tests.cpu import cpu_cell, run_cell

TRAIN = "mixtral-train-s4k-b8-uniform"


def test_a_sound_training_run_is_correct():
    assert run_cell(cpu_cell(TRAIN))["correct"]


def test_a_step_that_returns_its_state_unchanged_is_caught(monkeypatch):
    from repro_torch.training import trainer
    from repro_torch.training.step import TrainState, loss_fn

    def frozen(cfg, ctx, *, lr=3e-4):
        def step(state, batch):
            with torch.no_grad():
                _, m = loss_fn(state.params, cfg, ctx, batch)
            metrics = {**{k: v.detach() for k, v in m.items()},
                       "grad_norm": torch.zeros(()), "lr": lr}
            return TrainState(state.params, state.opt, state.step + 1), metrics
        return step

    monkeypatch.setattr(trainer, "make_train_step", frozen)
    out = run_cell(cpu_cell(TRAIN))
    assert out["readings"]["delta_gap"] == pytest.approx(1.0)
    assert not out["correct"]


def test_half_the_batch_left_out_is_caught(monkeypatch):
    from repro_torch.training import trainer
    real = trainer.make_train_step

    def half(cfg, ctx, *, lr=3e-4):
        step = real(cfg, ctx, lr=lr)
        return lambda state, batch: step(
            state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    monkeypatch.setattr(trainer, "make_train_step", half)
    assert not run_cell(cpu_cell(TRAIN))["correct"]


def test_the_training_control_reads_far_above_the_program():
    cell = cpu_cell(TRAIN)
    got = control.train_seed(cell, cell.driver())
    for k in ("loss_gap", "grad_gap", "delta_gap"):
        assert got["control"][k] > 3 * got["program"][k], (k, got)
    assert max(got["half_batch"].values()) > 3 * max(got["program"].values())
