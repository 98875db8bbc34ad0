"""Training loop with MACT choosing the FCDA schedule (global mode).

Each step:
  1. MACT chooses (chunk bin, pipeline depth) from the previous step's
     router load (s''), through the memory model (Eq. 8-9, with the
     pipeline's extra live chunk), cold-starting from the worst case
     s' -> e*s*k.  Without an EP context the local path has no exchange to
     overlap, so the depth is planned as 1.  MACT reads the global load,
     so every rank picks the same schedule.
  2. The step runs under a ``DistContext`` built for that schedule (PyTorch
     runs eagerly: there is nothing to compile or cache).
  3. The router load feeds back to MACT; the log, ``chunk_trace`` and
     ``pipeline_trace`` record the step.

Under a mesh (``ctx.mesh``, ``launch/mesh.py``) of D x P ranks, MACT plans
with ``Parallelism(e=P, b=global_batch // D)``, as the JAX trainer does for
that mesh.  The tokens are partitioned by whole sequences: rank r = i P + j
takes rows [r b, (r+1) b) of the step's global batch, b = global_batch /
(D P), so attention stays on the rank and the EP ranks are data-parallel
ranks, as in the paper's Megatron layout.  (The JAX package cuts the
sequence over the model axis inside its ``shard_map`` instead; under
dropless routing y, load and drops do not depend on which rank holds a
token.)  The step's gradients follow ``training/step.py``'s contract; the
log's metrics are global and equal on every rank, and ``tgs`` counts the
global tokens.

Not ported yet (they raise): adaptive per-layer MACT, expert placement,
checkpoint/resume, the fault injector and the OOM degradation ladder.  An
out-of-memory error propagates; nothing catches it.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import H100_80G, HardwareProfile, ModelConfig
from repro_torch.core.mact import MACTController
from repro_torch.core.memory_model import Parallelism
from repro_torch.core.moe import DistContext, is_ep
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.training.step import (TrainState, init_train_state,
                                       make_train_step)

_NOT_PORTED = ("adaptive_mact", "use_placement", "checkpoint_dir", "resume",
               "injector")


@dataclass
class Trainer:
    cfg: ModelConfig
    ctx: DistContext
    seq_len: int
    global_batch: int
    lr: float = 3e-4
    seed: int = 0
    dtype: torch.dtype = torch.float32
    hw: HardwareProfile = H100_80G
    use_mact: bool = True
    max_pipeline_depth: int = 2          # MACT may pick depth in [1, this]
    adaptive_mact: bool = False
    use_placement: bool = False
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    injector: Optional[object] = None
    log: list = field(default_factory=list)
    chunk_trace: list = field(default_factory=list)
    pipeline_trace: list = field(default_factory=list)

    def __post_init__(self):
        for name in _NOT_PORTED:
            if getattr(self, name):
                raise NotImplementedError(f"Trainer({name}=...) is not ported yet")
        mesh = self.ctx.mesh
        D, P = mesh.shape if mesh is not None else (1, 1)
        if self.global_batch % (D * P):
            raise ValueError(f"global batch {self.global_batch} does not split "
                             f"into whole sequences over {D * P} ranks")
        self.par = Parallelism(e=P if self.cfg.moe is not None else 1,
                               b=max(1, self.global_batch // D))
        rows = self.global_batch // (D * P)
        rank = mesh.rank if mesh is not None else 0
        self._rows = slice(rank * rows, (rank + 1) * rows)
        self.mact = MACTController(self.cfg, self.par, self.hw, self.seq_len,
                                   fused=self.ctx.moe_fused)
        self.data = SyntheticLMData(self.cfg, self.seq_len, self.global_batch,
                                    self.seed)
        self._last_load: Optional[np.ndarray] = None

    def _plan_params(self) -> tuple:
        """(ep_view, max_depth): the local path has no exchange to overlap,
        so it plans sequential-only."""
        ep_view = self.par.e
        max_depth = self.max_pipeline_depth if is_ep(self.cfg.moe, self.ctx) else 1
        return ep_view, max_depth

    def choose_schedule(self) -> tuple:
        """(chunks, pipeline depth) for the next step, MACT-selected.  As in
        the JAX package, s'' comes from the load summed over every MoE
        layer: conservative on memory by up to the MoE layer count."""
        if not self.use_mact or self.cfg.moe is None:
            return self.ctx.moe_chunks, self.ctx.pipeline_chunks
        ep_view, max_depth = self._plan_params()
        return self.mact.choose_schedule(self._last_load, ep_size=ep_view,
                                         max_depth=max_depth)

    def _context(self, chunks: int, pipeline: int) -> DistContext:
        return dataclasses.replace(self.ctx, moe_chunks=chunks,
                                   pipeline_chunks=pipeline)

    def fit(self, steps: int, state: Optional[TrainState] = None,
            verbose: bool = False) -> TrainState:
        """Run ``steps`` steps from ``state`` (default: fresh weights from
        ``seed`` on the context's device)."""
        if state is None:
            state = init_train_state(self.cfg, self.dtype, self.ctx.device,
                                     self.seed, mesh=self.ctx.mesh)
        dev = self.ctx.device
        for _ in range(steps):
            step_idx = state.step
            chunks, pipeline = self.choose_schedule()
            step_fn = make_train_step(self.cfg, self._context(chunks, pipeline),
                                      lr=self.lr)
            batch = {k: torch.as_tensor(v[self._rows], device=dev)
                     for k, v in self.data.batch_at(step_idx).items()}
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])        # the step's one sync point
            dt = time.perf_counter() - t0
            load = metrics["load"].cpu().numpy()
            self._last_load = load
            tgs = self.global_batch * self.seq_len / max(dt, 1e-9)
            rec = {"step": state.step, "loss": loss,
                   "ce": float(metrics["ce"]), "aux": float(metrics["aux"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "chunks": chunks, "pipeline": pipeline, "time_s": dt,
                   "tgs": tgs, "max_load": float(load.max()),
                   "drops": float(metrics["drops"])}
            if self.par.e > 1:
                # token-slots each model index's experts received, summed
                # over the data groups and the MoE layers (at D = 1, each
                # EP rank's received rows): the cross-rank imbalance
                rec["recv_by_peer"] = load.reshape(self.par.e, -1).sum(1).tolist()
            self.log.append(rec)
            self.chunk_trace.append(chunks)
            self.pipeline_trace.append(pipeline)
            if verbose:
                print(f"step {rec['step']:4d} loss {loss:.4f} c={chunks} "
                      f"depth={pipeline} {dt:.2f}s tgs={tgs:,.0f}", flush=True)
        return state
