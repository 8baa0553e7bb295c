"""The decode steps' least time on the chip (the larger of FLOPs over the
bf16 peak and bytes over the HBM peak: the weights once, one embedding
row, the KV read and written at the live positions) over their time on
the host clock, in the window."""
import pb_metrics


def read(run):
    spent = sum(pb_metrics.decode_gaps_s(run.window))
    if not spent:
        return None
    return 100.0 * pb_metrics.decode_least_s(run, run.window) / spent
