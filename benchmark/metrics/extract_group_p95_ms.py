"""95th percentile (numpy's linear interpolation) over all calls of the
window of the milliseconds from handing a group (of one fragment or more)
to ``extract_many`` to having its numpy outputs: the run's ``lat`` in
every cell the manifest lists for it."""

import numpy as np


def read(run):
    if not run.lat:
        return None
    return 1000.0 * float(np.percentile(run.lat, 95))
