"""Train steps completed in the window over the window's seconds (host
clock; each step returns its metrics to the host, so it has completed):
the run's ``done`` over ``window_s`` in every cell the manifest lists for
it, whatever the kind that drove the steps."""


def read(run):
    if not run.window_s:
        return None
    return run.done / run.window_s
