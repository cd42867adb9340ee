"""95th percentile (numpy's linear interpolation) over all groups of the
window of the milliseconds from handing a group to ``extract_many`` to
having its numpy outputs."""

import numpy as np


def read(run):
    if run.kind != "extract" or not run.lat:
        return None
    return 1000.0 * float(np.percentile(run.lat, 95))
