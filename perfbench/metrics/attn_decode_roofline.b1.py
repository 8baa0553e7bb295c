"""Kernel 1 (``decode_attention_mma``): the bytes its launches needed
(K and V at the live positions, q, the output) over the HBM peak, over
their device time in the traced window."""
import pb_counts
import pb_metrics


def read(run):
    return pb_metrics.kernel_roofline(
        run, "decode_attention_mma",
        lambda lens: sum(pb_counts.decode_attention_bytes(run.shape, n)
                         for n in lens))
