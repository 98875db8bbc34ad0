"""The program's kernels by the names they carry in the profiler's trace,
grouped by what they compute (copied from ``chip_smoke.py``'s
``STEP_GROUPS``).  The bf16 ``ragged_matmul``, ``ragged_swiglu`` and
``fused_moe`` passes are one Hopper mainloop, named by their epilogues."""

EXPERT_LEG = {"fused_moe": ("FusedUpStore", "FusedCombine"),
              "ragged_swiglu": ("SwigluStore",),
              "ragged_matmul": ("RaggedStore",),
              "segment_outer": ("weight_grad_wgmma",),
              "dispatch": ("scatter_rows", "gather_combine")}


def matches(groups: dict):
    """A predicate on kernel names: whether any group's key is in it."""
    keys = [k for names in groups.values() for k in names]
    return lambda name: any(k in name for k in keys)
