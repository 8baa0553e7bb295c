"""Mean time from sending a request to its first token's arrival, over
the requests sent in the window."""
import pb_metrics


def read(run):
    xs = pb_metrics.ttfts_s(run.window)
    return 1e3 * sum(xs) / len(xs) if xs else None
