"""Share of the neighbourhood maxima in the window of an extraction cell
that the port took on K7 (``ops/neighbor_max.py``'s ``launches`` counter
over it plus ``launches_fallback``, the maxima taken by the gather twin,
both over the window), percent: the strided blocks' max pools and the
detector's local-max gate. None where the port keeps no such counter or the
window took no neighbourhood max."""

KEYS = ("neighbor_max.neighbor_max.launches", "neighbor_max.neighbor_max.launches_fallback")


def read(run):
    if run.kind != "extract" or not all(k in run.counters for k in KEYS):
        return None
    kernel, fallback = (run.counters[k] for k in KEYS)
    return 100.0 * kernel / (kernel + fallback) if kernel + fallback else None
