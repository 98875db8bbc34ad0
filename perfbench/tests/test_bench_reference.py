"""The plain references against the program at its reduced size on the
CPU, where both compute in fp32: what they compute is the same mathematics."""

import dataclasses

import pytest

from perfbench import check, generator
from perfbench.reference.common import Prec
from perfbench.tests.cpu import cpu_cell


@pytest.mark.parametrize("workload", ["mixtral-train-s4k-b8-uniform",
                                      "mixtral-train-s4k-b2-uniform"])
def test_training_reference_follows_the_program_step_for_step(workload):
    cell = cpu_cell(workload)
    drv = cell.driver()
    cell.feed = generator.train_feed(cell.mix, cell.spec["vocab_size"], cell.seed,
                                     0.0, drv.WARM)
    trainer, state = drv.build(cell)
    state, prog = drv.warm(trainer, state, cell)
    ref = drv.reference_readings(cell, prog["chunks"], Prec("fp32"))
    gaps = check.train_gaps(prog, ref)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["delta_gap"] < 1e-4, gaps


def test_aux_loss_is_taken_per_chunk_across_sequences():
    """A chunk that spans sequences (4 rows, 2 chunks) counts its routing
    over both: the pre-pass path, held against the program."""
    cell = cpu_cell("mixtral-train-s4k-b8-uniform")
    cell.mix = {**cell.mix, "batch": 4, "seq_len": 32}
    drv = cell.driver()
    cell.feed = generator.train_feed(cell.mix, cell.spec["vocab_size"], cell.seed,
                                     0.0, drv.WARM)
    trainer, state = drv.build(cell)
    trainer.use_mact = False
    trainer.ctx = dataclasses.replace(trainer.ctx, moe_chunks=2)
    state, prog = drv.warm(trainer, state, cell)
    assert prog["chunks"] == [2, 2, 2]
    ref = drv.reference_readings(cell, prog["chunks"], Prec("fp32"))
    assert check.train_gaps(prog, ref)["loss_gap"] < 1e-5


def test_the_program_runs_the_published_aux_coefficient_and_full_attention():
    """The file's ``port`` block sets the program's balancing coefficient
    and attention to the published ones; without it the harness refuses
    to run, naming the keys that differ."""
    import json

    from perfbench import run
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = run.Cell(bench, "mixtral-train-s4k-b2-uniform", 1, 1.0, False)
    cell.program_config()
    assert cell.pcfg.moe.router_aux_coef == 0.02 and cell.pcfg.num_layers == 2
    assert {s.attn.kind for s in cell.pcfg.layer_specs()} == {"full"}
    cell.config = {**cell.config, "port": {"arch": "mixtral-8x7b", "num_layers": 2}}
    with pytest.raises(SystemExit, match="aux_coef.*window"):
        cell.program_config()
