"""95th percentile, over every delivery in the window, of the gap since
the same request's previous delivery."""
import pb_metrics


def read(run):
    p = pb_metrics.p95(pb_metrics.decode_gaps_s(run.window))
    return None if p is None else 1e3 * p
