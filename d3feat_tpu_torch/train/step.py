"""Feature-extraction step (port of
``d3feat_tpu.train.step.make_extract_step``; the training steps are not
ported yet).

One call: packed cloud(s) -> sorted-space pyramid -> KPFCNN forward ->
descriptors and scores back in the caller's row order, plus the overflow
flag (a level exceeded its point or neighbor capacity, so lists were
truncated and the outputs are degraded — callers must surface it).
"""

from __future__ import annotations

import torch

from d3feat_tpu_torch.models.kpfcnn import apply_kpfcnn
from d3feat_tpu_torch.ops.neighbors import permute_rows
from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec


def make_extract_step(config, pyramid_spec=None, num_clouds: int = 2, impl: str = "auto"):
    """``extract_step(model, batch) -> (features [C0, D], scores [C0, 1],
    overflow [] bool)`` for a packed ``batch`` of tensors (``points``
    [C0, 3], ``features`` [C0, F], ``lengths`` [num_clouds]) on the
    model's device. Scores use per-cloud max normalisation, so fragments
    batched on the cloud axis do not perturb each other. ``impl`` selects
    kernels or their plain twins (see ``ops.select.band_select``)."""
    if config.compute_dtype != "float32":
        raise NotImplementedError("only compute_dtype='float32' is ported")
    pyramid_spec = pyramid_spec or make_pyramid_spec(config, num_clouds=num_clouds)

    @torch.no_grad()
    def extract_step(model, batch):
        pyr = build_pyramid(batch["points"], batch["lengths"], spec=pyramid_spec, impl=impl)
        order0, inv0 = pyr["band"][0]["order"], pyr["band"][0]["inv"]
        full = dict(pyr, features=permute_rows(batch["features"], order0))
        out = apply_kpfcnn(model, full, per_cloud_norm=True, impl=impl)
        # back to the caller's original row order
        return (permute_rows(out.features, inv0), permute_rows(out.scores, inv0),
                pyr["overflow"])

    return extract_step
