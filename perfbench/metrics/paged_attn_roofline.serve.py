"""Kernel 2 (``paged_attention_mma``): the bytes its launches needed (the
pages that hold the live lanes' K and V, their q and output) over the
HBM peak, over their device time in the traced window.  A device step
whose lanes are all masked needs nothing."""
import pb_counts
import pb_metrics


def read(run):
    page = int(run.traffic["scheduler"]["page_size"])
    return pb_metrics.kernel_roofline(
        run, "paged_attention_mma",
        lambda lens: pb_counts.paged_attention_bytes(run.shape, lens, page))
