"""Tokens the window's device decode steps emitted over the slots those
steps offered (steps x slots), from the scheduler's token events and its
horizon histogram."""
import pb_metrics


def read(run):
    steps = pb_metrics.steps_in(run.window)
    if not steps:
        return None
    slots = int(run.traffic["scheduler"]["n_slots"])
    return 100.0 * sum(len(lens) for lens in steps) / (len(steps) * slots)
