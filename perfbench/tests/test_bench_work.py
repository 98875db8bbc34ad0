"""The work counts against hand counts at the published widths."""

import pytest

from perfbench import spec as spec_mod
from perfbench.arch import mixtral


def _spec(name):
    return mixtral.spec_from_file(spec_mod.load_config_file(name))


def test_mixtral_active_parameters_and_training_flops():
    s = _spec("mixtral-8x7b-2l")
    attn = 2 * 4096 * 4096 + 2 * 4096 * 1024
    layer = attn + 4096 * 8 + 2 * 3 * 4096 * 14336
    assert mixtral.active_matmul_params(s) == 2 * layer + 4096 * 32000 == 919_666_688
    attn_fwd = 4 * 32 * 128 * (4096 * 4097 / 2) / 4096 * 2       # per token, 2 layers
    assert mixtral.train_flops_per_token(s, 4096) == pytest.approx(
        6 * 919_666_688 + 3 * attn_fwd)
    assert mixtral.train_flops_per_token(s, 4096) == pytest.approx(5.719e9, rel=1e-3)


def test_expert_leg_is_compute_bound_at_the_b8_step():
    s = _spec("mixtral-8x7b-2l")
    slots = 8 * 4096 * 2
    want = 18 * slots * 4096 * 14336 / 989e12
    assert mixtral.expert_leg_least_s(s, slots) == pytest.approx(want)
    assert want == pytest.approx(0.07004, rel=1e-3)
