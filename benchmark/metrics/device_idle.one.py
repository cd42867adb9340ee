"""``device_idle.extract`` in a cell whose every call is one fragment,
where it moves the calls' 95th percentile (``extract_fragments_per_s.one``
says why). None where a call carried more than one fragment."""

from harness.manifest import load_module

_of = load_module("metrics", "device_idle.extract").read


def read(run):
    if not run.calls or run.done != run.calls:
        return None
    return _of(run)
