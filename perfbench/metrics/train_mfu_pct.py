"""Model FLOPs of the tokens trained in the window (6 x active matmul
parameters + the causal attention products, recompute not counted;
``work.train_flops_per_token``) over the window at 989 TFLOP/s, in %."""

from perfbench import work


def read(run):
    r = run.record
    if not r.get("steps"):
        return None
    flops = r["tokens"] * work.train_flops_per_token(run.spec, r["seq"])
    return 100.0 * flops / (run.window.window_s * work.BF16_FLOPS)
