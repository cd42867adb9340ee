"""Share of the deformable KPConvs' neighbour sums in the window of an
extraction cell that the port ran on K6 (``ops/deform_conv.py``'s
``launches`` counter over ``launches`` and ``launches_fallback``, the sums
done by the gather route, both over the window), percent. None where the
port keeps no such counter or the window ran no deformable sum."""

KEYS = ("deform_conv.deform_sums.launches", "deform_conv.deform_sums.launches_fallback")


def read(run):
    if run.kind != "extract" or not all(k in run.counters for k in KEYS):
        return None
    kernel, fallback = (run.counters[k] for k in KEYS)
    return 100.0 * kernel / (kernel + fallback) if kernel + fallback else None
