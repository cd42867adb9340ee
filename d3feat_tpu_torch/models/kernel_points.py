"""Kernel-point dispositions for KPConv (port of the loader of
``d3feat_tpu.models.kernel_points``).

The port only reads the committed dispositions (a copy of the JAX
package's ``dispositions/`` files); it does not generate new ones. The
disposition is used as stored (the reference's deterministic loading) and
scaled to the conv radius.
"""

from __future__ import annotations

import os

import numpy as np

_DISPOSITIONS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dispositions")


def load_kernels(radius: float, num_kpoints: int, dimension: int = 3,
                 fixed: str = "center") -> np.ndarray:
    """[num_kpoints, dimension] float32 kernel points scaled to ``radius``."""
    path = os.path.join(_DISPOSITIONS, f"k_{num_kpoints:03d}_{fixed}_{dimension}D.npy")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no committed kernel disposition {os.path.basename(path)} in {_DISPOSITIONS}")
    return (radius * np.load(path)).astype(np.float32)
