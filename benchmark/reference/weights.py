"""Weights of a cell, made by the benchmark and handed to both sides: the
leaves of a served weight file, and leaves that file lacks drawn from the
seed on the card in one call."""

from __future__ import annotations

import math
import re

import numpy as np
import torch

_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)")


def read_weight_file(path: str) -> dict:
    """``{dotted name: float32 array}`` of a portable weight file: leaves
    ``p_<i>`` named by the key paths in ``__paths_params__``."""
    out = {}
    with np.load(path, allow_pickle=False) as z:
        for i, p in enumerate(z["__paths_params__"]):
            name = ".".join(next(g for g in m.groups() if g is not None)
                            for m in _KEY.finditer(str(p)))
            out[name] = np.asarray(z[f"p_{i:05d}"], np.float32)
    return out


def make_weights(spec: dict, shapes: dict, seed: int, device, root: str) -> dict:
    """``{name: float32 tensor on device}`` for every name of ``shapes``
    (``{name: shape}``, the model's leaves): from ``spec["file"]`` where it
    holds the leaf; a leaf ending in one of ``spec["draw"]`` drawn
    uniform in +-1/sqrt(fan_in) (fan_in = the product of all dimensions
    but the first), all drawn leaves from one ``torch.rand`` call seeded by
    ``seed``; one ending in ``spec["zeros"]`` zero, in ``spec["ones"]`` one
    (batch norm's ``scale`` and running ``var``); one ending in a key of
    ``spec["copy"]`` a copy of the sibling leaf it names."""
    import os

    served = read_weight_file(os.path.join(root, spec["file"])) if spec.get("file") else {}
    out, drawn = {}, []
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if name in served and tuple(served[name].shape) == tuple(shape):
            out[name] = torch.from_numpy(served[name]).to(device)
        elif leaf in spec.get("draw", ()):
            drawn.append((name, tuple(shape)))
        elif leaf in spec.get("zeros", ()):
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        elif leaf in spec.get("ones", ()):
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
        elif leaf not in spec.get("copy", {}):
            raise KeyError(f"weights: no rule for leaf {name} {tuple(shape)}")
    if drawn:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        u = torch.rand(sum(math.prod(s) for _, s in drawn), generator=gen, device=device)
        at = 0
        for name, shape in drawn:
            n = math.prod(shape)
            bound = 1.0 / math.sqrt(math.prod(shape[1:]))
            out[name] = ((u[at:at + n] * 2.0 - 1.0) * bound).view(shape)
            at += n
    for name in shapes:
        leaf = name.rsplit(".", 1)[-1]
        if name not in out:
            out[name] = out[name[: -len(leaf)] + spec["copy"][leaf]].clone()
    return out
