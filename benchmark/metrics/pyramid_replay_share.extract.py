"""Share of the extraction steps' ``build_pyramid`` calls in the window
that the port served by replaying its pyramid's CUDA graph
(``ops/pyramid.py``'s ``launches_replayed`` counter over the window, over
the calls the pyramid wrapper counted), percent. None where the port keeps
no such counter."""

KEY = "pyramid.build_pyramid.launches_replayed"


def read(run):
    if run.kind != "extract" or KEY not in run.counters or not run.step_rows:
        return None
    return 100.0 * run.counters[KEY] / len(run.step_rows)
