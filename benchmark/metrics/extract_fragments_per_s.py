"""Fragments returned to the host in the window over the window's seconds
(host clock, the window closed by a synchronize after the last call): the
run's ``done`` over ``window_s`` in every cell the manifest lists for it."""


def read(run):
    if not run.window_s:
        return None
    return run.done / run.window_s
