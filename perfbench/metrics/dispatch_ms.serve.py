"""The scheduler's host time building and enqueuing a decode dispatch
(its ``host_dispatch_s``), per dispatch, in the window."""


def read(run):
    rec = run.window
    spent = [s for t, _, s in rec.dispatches if rec.within(t)]
    return 1e3 * sum(spent) / len(spent) if spent else None
