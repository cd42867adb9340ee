"""Read the JAX package's portable params-only npz without JAX.

``d3feat_tpu.compat.portable.export_npz`` stores the flattened parameter
pytree as ``p_00000 ...`` arrays beside ``__paths_params__``, the JAX key
path of each leaf (``['decoder'][1]['linear']['w']``,
``['encoder'][0]['conv'].weights``), plus model state (``s_*``,
``__paths_state__``) and a JSON ``__meta__``. The port names each leaf by
the same path written the ``state_dict`` way: ``decoder.1.linear.w``,
``encoder.0.conv.weights``.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Tuple

import numpy as np

_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)")


def path_to_name(path: str) -> str:
    """JAX ``keystr`` path -> dotted ``state_dict`` name."""
    parts = []
    pos = 0
    for m in _KEY.finditer(path):
        if m.start() != pos:
            raise ValueError(f"unparsable key path {path!r}")
        parts.append(next(g for g in m.groups() if g is not None))
        pos = m.end()
    if pos != len(path) or not parts:
        raise ValueError(f"unparsable key path {path!r}")
    return ".".join(parts)


def read_npz(path: str) -> Tuple[Dict[str, np.ndarray],
                                 Dict[str, np.ndarray], dict]:
    """(params, model_state, meta) of an ``export_npz`` artifact, the two
    trees as ``{state_dict name: array}``."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        trees = []
        for tag in ("p", "s"):
            paths = z[f"__paths_{'params' if tag == 'p' else 'state'}__"]
            trees.append({path_to_name(str(p)): z[f"{tag}_{i:05d}"]
                          for i, p in enumerate(paths)})
    return trees[0], trees[1], meta
