"""Output tokens delivered in the window over its seconds."""
import pb_metrics


def read(run):
    rec = run.window
    return pb_metrics.tokens_delivered(rec) / (rec.t1 - rec.t0)
