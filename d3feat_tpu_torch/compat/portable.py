"""The JAX package's portable params-only npz, read and written without JAX.

``d3feat_tpu.compat.portable.export_npz`` stores the flattened parameter
pytree as ``p_00000 ...`` arrays beside ``__paths_params__``, the JAX key
path of each leaf (``['decoder'][1]['linear']['w']``,
``['encoder'][0]['conv'].weights``), plus model state (``s_*``,
``__paths_state__``) and a JSON ``__meta__``. The port names each leaf by
the same path written the ``state_dict`` way: ``decoder.1.linear.w``,
``encoder.0.conv.weights``.

``export_npz`` writes a ``state_dict`` so that JAX's ``import_npz``
accepts it: that function compares the stored paths with its template's
flatten order string for string, so the leaves go in JAX's order (dict
keys sorted as strings, list indices in numeric order, the fields of
``KPConvParams`` in their declared order).
"""

from __future__ import annotations

import json
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)")
# the NamedTuple fields of d3feat_tpu.models.kpconv.KPConvParams, in order
KPCONV_FIELDS = ("weights", "kernel_points", "offset_weights", "offset_kernel_points",
                 "offset_bias")


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


def _parts(name: str):
    """((kind, key), ...) of a dotted name: list index (0, int), dict key
    (1, str), ``KPConvParams`` field (2, its index); in JAX's flatten order
    these sort as the tuples do."""
    out = []
    parts = name.split(".")
    for i, p in enumerate(parts):
        if p.isdigit():
            out.append((0, int(p)))
        elif i == len(parts) - 1 and p in KPCONV_FIELDS:
            out.append((2, KPCONV_FIELDS.index(p)))
        else:
            out.append((1, p))
    return tuple(out)


def name_to_path(name: str) -> str:
    """Dotted ``state_dict`` name -> JAX ``keystr`` path."""
    return "".join(f"[{k}]" if kind == 0 else f"['{k}']" if kind == 1
                   else f".{KPCONV_FIELDS[k]}" for kind, k in _parts(name))


def _flatten(tree: Mapping[str, object]):
    """(paths, numpy leaves) of ``{name: tensor or array}`` in JAX's
    flatten order."""
    names = sorted(tree, key=_parts)
    leaves = []
    for n in names:
        v = tree[n]
        if hasattr(v, "detach"):  # a torch tensor
            v = v.detach().cpu().numpy()
        leaves.append(np.asarray(v))
    return [name_to_path(n) for n in names], leaves


def export_npz(path: str, params: Mapping[str, object],
               model_state: Optional[Mapping[str, object]] = None,
               meta: Optional[dict] = None) -> None:
    """Write ``params`` (a ``state_dict``, or ``read_npz``'s dict) and
    ``model_state`` (+ JSON-able meta) as one .npz file, as JAX's
    ``export_npz`` writes it."""
    p_paths, p_leaves = _flatten(params)
    s_paths, s_leaves = _flatten(model_state or {})
    arrays = {f"p_{i:05d}": x for i, x in enumerate(p_leaves)}
    arrays.update({f"s_{i:05d}": x for i, x in enumerate(s_leaves)})
    np.savez_compressed(
        path,
        __paths_params__=np.array(p_paths),
        __paths_state__=np.array(s_paths),
        __meta__=np.array(json.dumps(meta or {})),
        **arrays,
    )


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
