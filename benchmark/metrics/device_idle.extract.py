"""Share of the traced window in which no operation ran on the card
(profiler kernel, copy and set events, their union), in the extraction
cells, percent."""


def read(run):
    if run.kind != "extract" or not run.trace:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
