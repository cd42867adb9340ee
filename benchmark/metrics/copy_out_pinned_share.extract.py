"""Share of the extraction steps in the window whose outputs the port
copied back through pinned memory (``ops/transfer.py``'s
``to_host.launches`` over the window, over the steps the pyramid wrapper
counted), percent. None where the port keeps no such counter."""

KEY = "transfer.to_host.launches"


def read(run):
    if run.kind != "extract" or KEY not in run.counters or not run.step_rows:
        return None
    return 100.0 * run.counters[KEY] / len(run.step_rows)
