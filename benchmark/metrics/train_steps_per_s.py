"""Train steps completed in the window over the window's seconds (host
clock; each step returns its metrics to the host, so it has completed)."""


def read(run):
    if run.kind != "train" or not run.window_s:
        return None
    return run.done / run.window_s
