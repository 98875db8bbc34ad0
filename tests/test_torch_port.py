"""Properties of the port that need no JAX: it imports nothing of JAX or of
the JAX package, its entry points refuse to run without a card unless the
CPU is asked for, and the paths it leaves out raise."""

import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.core.moe import DistContext
from repro_torch.kernels import build
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.serving.paged_scheduler import PagedScheduler
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           Request, ServeConfig)

SRC = Path(repro_torch.__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _modules():
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]


def test_every_module_imports_without_jax_or_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC), "PATH": ""},
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_module_list_covers_the_slice():
    names = set(_modules())
    for want in ("repro_torch.kernels.grouped_mlp", "repro_torch.kernels.build",
                 "repro_torch.serving.scheduler", "repro_torch.launch.serve",
                 "repro_torch.bridge"):
        assert want in names
    for name in names:                      # importing builds nothing
        importlib.import_module(name)
    assert not build._loaded


def test_serve_without_a_card_raises_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mixtral-8x7b", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device("cuda")


def test_serve_cli_on_cpu(capsys):
    sched, m = serve.main(["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu",
                           "--requests", "3", "--arrival-rate", "0",
                           "--prompt-lens", "16,32", "--gen", "2,6",
                           "--layers", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "decode waves" in out
    assert sched.cfg.num_layers == 3 and len(sched.params["layers"]) == 3
    assert m["requests"] == 3 and m["nonfinite_logits"] == 0
    assert all(len(r.out) == r.max_new_tokens for r in sched.finished)
    assert sched.params["embed"].dtype == torch.float32


def test_layers_cut_keeps_every_width():
    args = serve.parse_args(["--arch", "mixtral-8x7b", "--layers", "4"])
    assert args.device == "cuda" and args.dtype is None and args.layers == 4
    full = get_config("mixtral-8x7b")
    assert (full.d_model, full.moe.d_ff_expert, full.num_heads,
            full.num_kv_heads, full.vocab_size) == (4096, 14336, 32, 8, 32000)


@pytest.mark.parametrize("option", [dict(page_size=16), dict(prefix_cache=True),
                                    dict(preemption=True),
                                    dict(expert_batching=True), dict(wave_size=2),
                                    dict(resident_experts=2),
                                    dict(probe_router=True)])
def test_unported_serving_paths_raise(option):
    """The expert-aware options are not ported and raise; the paging options
    are (serving/paged_scheduler.py) and construct."""
    cfg = get_config("mixtral-8x7b").reduced()
    params = transformer.init_params(cfg, device=CPU)
    ctx = DistContext(device=CPU)
    if option.keys() & {"page_size", "prefix_cache", "preemption"}:
        scfg = ServeConfig(**{"page_size": 8, **option})
        assert PagedScheduler(params, cfg, ctx, scfg).pool.page == scfg.page_size
        return
    with pytest.raises(NotImplementedError):
        ContinuousBatchingScheduler(params, cfg, ctx, ServeConfig(**option))


def test_scheduler_sheds_and_refuses_like_the_reference():
    cfg = get_config("mixtral-8x7b").reduced()
    params = transformer.init_params(cfg, device=CPU)
    sched = ContinuousBatchingScheduler(
        params, cfg, DistContext(device=CPU),
        ServeConfig(max_slots=1, cache_len=32, prefill_chunk=16, max_waiting=1))
    with pytest.raises(ValueError, match="exceeds cache_len"):
        sched.submit(Request(rid=9, tokens=np.zeros(30, np.int32),
                             max_new_tokens=10))
    reqs = [Request(rid=i, tokens=np.arange(8, dtype=np.int32), max_new_tokens=2)
            for i in range(3)]
    for r in reqs:
        sched.submit(r)
    assert [r.rid for r in sched.shed] == [1, 2]        # queue bound 1
    assert all(r.retry_after >= 1.0 for r in sched.shed)
    m = sched.run([])
    assert m["requests"] == 1 and m["shed"] == 2


def test_kernel_library_is_named_by_its_source():
    path = build.library_path("grouped_mlp")
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path == build.library_path("grouped_mlp")
