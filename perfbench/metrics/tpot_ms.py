"""Time per output token: the window's (last - first delivery) over the
tokens after the first, summed over requests."""
import pb_metrics


def read(run):
    t = pb_metrics.tpot_s(run.window)
    return None if t is None else 1e3 * t
