"""The least time on the chip of all the device work the window's tokens
needed (each decode step with a live lane: the weights, the live lanes'
KV and their FLOPs; each prefill chunk: its FLOPs or its bytes, the
larger), over the window's seconds."""
import pb_metrics


def read(run):
    rec = run.window
    need = pb_metrics.decode_least_s(run, rec) + pb_metrics.prefill_least_s(run, rec)
    return 100.0 * need / (rec.t1 - rec.t0)
