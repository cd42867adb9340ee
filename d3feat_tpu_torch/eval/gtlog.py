"""3DMatch ground-truth log parsing (port of ``d3feat_tpu.eval.gtlog``,
copied as it is).

Counterpart of the reference ``loadlog``
(reference: geometric_registration/common.py:43-58): a ``gt.log`` is a
sequence of 5-line blocks — a tab-separated header ``id1 id2 num_frags``
followed by a 4x4 row-major pose — keyed here as ``"{id1}_{id2}"``.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def load_gt_log(path: str) -> Dict[str, np.ndarray]:
    """Parse ``gt.log`` (or any 3DMatch-format trajectory log) at ``path``.

    Accepts either a direct file path or a directory containing ``gt.log``.
    Returns {"i_j": [4,4] float pose}.
    """
    if os.path.isdir(path):
        path = os.path.join(path, "gt.log")
    with open(path) as f:
        lines = [ln.strip() for ln in f.readlines()]
    result: Dict[str, np.ndarray] = {}
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        header = lines[i].split()
        id1, id2 = int(header[0]), int(header[1])
        pose = np.array(
            [[float(x) for x in lines[i + 1 + r].split()[:4]] for r in range(4)]
        )
        result[f"{id1}_{id2}"] = pose
        i += 5
    return result


def save_gt_log(path: str, poses: Dict[str, np.ndarray],
                num_frags: int = 0) -> None:
    """Write poses back in the 3DMatch log format (for fixtures/round-trips)."""
    with open(path, "w") as f:
        for key, pose in poses.items():
            id1, id2 = key.split("_")
            f.write(f"{id1}\t{id2}\t{num_frags}\n")
            for row in np.asarray(pose).reshape(4, 4):
                f.write("\t".join(f"{v:.8f}" for v in row) + "\n")
