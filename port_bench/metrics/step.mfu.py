"""step.mfu: the whole training step's share of the card's bf16 peak.

Analytic training FLOPs a sample (``reference/flops.py``) times the
samples a second of the run's untraced window (a traced step runs
slower), over 989 TFLOP/s a card.  Across ranks, the mean of the ranks'
shares, which is the global rate over chips x peak."""

from port_bench.reference.flops import PEAK_BF16_FLOPS

COMBINE = "mean"


def read(trace):
    f = trace.facts
    if not f.get("samples_per_s") or not f.get("train_flops_per_sample"):
        return None
    return 100.0 * f["samples_per_s"] * f["train_flops_per_sample"] \
        / PEAK_BF16_FLOPS
