"""The card: its presence, its name and power limit, the peak memory, and
the guard that nothing of JAX or the JAX package was loaded."""

from __future__ import annotations

import subprocess
import sys

# top-level module names that a run may not load: JAX, its libraries and
# the JAX package of this repository (whole names: the port's name begins
# with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "d3feat_tpu")


def forbidden_modules(modules=None) -> list:
    """Names in ``modules`` (default ``sys.modules``) whose top-level name,
    the part before the first dot, is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


class NoCard(RuntimeError):
    pass


def require_cards(count: int):
    """Raise ``NoCard`` unless CUDA is there with at least ``count`` cards."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: this benchmark runs on the card only")
    if torch.cuda.device_count() < count:
        raise NoCard(f"{torch.cuda.device_count()} cards, the cell needs {count}")


def power_limit() -> str:
    """``nvidia-smi``'s power limit of card 0, or "" where it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else ""


def device_info(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(count))}
