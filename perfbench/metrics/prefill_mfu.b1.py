"""Prefill FLOPs (the projections at every position, causal attention,
the LM head at the last position) over the bf16 peak, over the time to
first token, summed over the window's requests."""
import pb_counts
import pb_metrics


def read(run):
    reqs = [r for r in pb_metrics.window_requests(run.window) if r.deliveries]
    spent = sum(r.deliveries[0][0] - r.sent for r in reqs)
    if not spent:
        return None
    flops = sum(pb_counts.prefill(run.shape, 0, r.prompt_len)[0] for r in reqs)
    return 100.0 * flops / pb_counts.PEAK_FLOPS / spent
