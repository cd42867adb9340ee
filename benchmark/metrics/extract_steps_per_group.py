"""Extraction steps per group in the window: 1 where no group overflowed
its bucket, more where ``on_overflow="retry"`` ran a group again in a
larger bucket."""


def read(run):
    if run.kind != "extract" or not run.calls:
        return None
    return len(run.step_rows) / run.calls
