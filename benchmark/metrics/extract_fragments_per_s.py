"""Fragments returned to the host in the window over the window's seconds
(host clock, the window closed by a synchronize after the last group)."""


def read(run):
    if run.kind != "extract" or not run.window_s:
        return None
    return run.done / run.window_s
