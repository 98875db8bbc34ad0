"""Model FLOPs of the tokens trained in the window (the architecture
file's ``train_flops_per_token``: 6 x active matmul parameters + the
causal attention products, recompute not counted) over the window at 989
TFLOP/s, in %."""

from perfbench import work


def read(run):
    r = run.record
    if not r.get("steps"):
        return None
    flops = r["tokens"] * run.arch.train_flops_per_token(run.spec, r["seq"])
    return 100.0 * flops / (run.window.window_s * work.BF16_FLOPS)
