"""One run of one cell: set-up, the measured window, the trace, the check.

The cell's traffic names its kind; ``kinds/<kind>.py`` makes the traffic
from the seed, builds the program's entry, warms up every shape the mix
uses, makes the window's traffic before it opens and drives the window
(``run``), and judges what the timed path produced (``check_numbers``).
This module does what every kind shares: the configuration, the weights
and the model, the spans, the device's readings, the metric readers
(``metrics/<name>.py``) and the result line. The window is a closed loop:
one caller sends the next request when the last returns, for ``seconds``
(with ``trace``, for the mix's ``trace_seconds`` at most, under the
profiler and the spans). Then the peak memory is read, the program's
state is freed, and the reference judges the outputs.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch

from harness import device as dev_mod, program, trace as trace_mod
from harness.loop import Context, log
from harness.manifest import ROOT, Cell, load_module
from reference import model as ref_model

SPANS = ("bench.pyramid",)


def network(cfg_doc: dict) -> str:
    """The network a configuration names (``program.NETWORKS``): D3Feat's
    KPFCNN unless it says otherwise."""
    return cfg_doc.get("network", "kpfcnn")


def architecture(cfg_doc: dict) -> list:
    """The configuration's block list; D3Feat's for a KPFCNN that states
    none. Any other network has to state its own."""
    if cfg_doc.get("architecture"):
        return list(cfg_doc["architecture"])
    if network(cfg_doc) != "kpfcnn":
        raise ValueError(f"a {network(cfg_doc)!r} configuration states its architecture")
    return ref_model.architecture(cfg_doc["num_layers"])


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, started_at: float,
             device="cuda", compute_dtype=None) -> dict:
    """One run: the result line's dict (``checks`` last). ``started_at`` is
    the process's start (epoch seconds); ``compute_dtype`` overrides the
    configuration's (the control)."""
    cfg_doc, spec = cell.config, cell.traffic
    kind = load_module("kinds", spec["kind"])
    marks = [("start", started_at), ("imports", time.time())]
    ctx = Context(cell=cell, cfg_doc=cfg_doc, arch=architecture(cfg_doc), seed=seed,
                  device=device, traced=traced,
                  mark=lambda name: marks.append((name, time.time())),
                  window_seconds=min(seconds, float(spec.get("trace_seconds", seconds)))
                  if traced else seconds)
    ctx.cfg = program.make_config(cfg_doc, compute_dtype)
    ctx.model, ctx.weights = program.build_model(ctx.cfg, network(cfg_doc), cfg_doc["weights"],
                                                 seed, device, ROOT)
    ctx.mark("weights and model")
    ctx.rec = rec = program.Recorder(tracing=traced)
    with program.spans(rec):
        res = kind.run(ctx)
    win = res.win
    window_s = win.t1 - win.t0
    setup_s = win.open_at - started_at
    marks.append(("window opens", win.open_at))
    log("set-up: " + ", ".join(f"{b[0]} {b[1] - a[1]:.2f} s" for a, b in zip(marks, marks[1:])))
    info = dev_mod.device_info(cell.chips) if torch.device(device).type == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    summary = None
    if traced and torch.device(device).type == "cuda":
        if res.calls and not rec.timed:
            raise trace_mod.IncompleteTrace("the window's calls launched none of the port's "
                                            "kernels through its foreign launch functions")
        summary = trace_mod.summarize(win.prof, SPANS, program.launch_intervals(rec),
                                      program.port_kernel_names())
        info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    wanted = cell.per_layer if traced else [m for m in cell.end_to_end
                                            if m["name"] != "setup_s"]
    metrics = {} if traced else {"setup_s": {"value": setup_s, "unit": "s"}}
    metrics.update(_read_metrics(wanted, cell, ctx, res, window_s, summary, info))
    # free the program's state before the reference runs
    res.program = ctx.model = ctx.cfg = None
    win.prof = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = kind.check_numbers(res, ctx)
    log(f"check: {time.perf_counter() - t:.1f} s")
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()
              if k in cell.limits}
    correct = (all(c["value"] <= c["limit"] for c in checks.values())
               and len(checks) == len(cell.limits) and res.failed == 0 and res.calls > 0)
    out = {"correct": bool(correct), "attempted": res.calls, "failed": res.failed,
           "metrics": metrics, "device": info}
    if summary is not None:
        out["breakdown"] = summary["breakdown"]
    out["checks"] = checks
    for k, c in checks.items():
        log(f"{k} {c['value']!r} limit {c['limit']!r}")
    return out


def _read_metrics(wanted, cell, ctx, res, window_s, summary, info) -> dict:
    """``{name: {value, unit}}`` of the ``wanted`` metrics whose readers
    (``metrics/<name>.py``) found something to read in ``run``: the kind,
    what the window did (``calls``, completed work ``done``, latencies
    ``lat``, the rows handed to each step), the pyramids' spans and
    counts, each counted launcher's calls (``launches``, sizes read from
    the device), the port's own counters over the window (``counters``),
    the device's readings (``device``: ``memory_peak_bytes`` and, traced,
    ``busy_s`` and ``window_s``), the trace's summary (``trace``:
    ``device_s`` by span, ``port_s`` by foreign launch function) and
    ``forward_ops(counts)``, one KPFCNN forward's operations at a
    pyramid's counts (the block list walked only when a reader calls it,
    so a cell of another network reads the rest)."""
    counts = {}

    def count_module(name):
        if name not in counts:
            counts[name] = load_module("counts", name)
        return counts[name]

    rec, cfg_doc = ctx.rec, ctx.cfg_doc
    host = lambda v: int(v) if isinstance(v, torch.Tensor) else v  # noqa: E731
    pyr_counts = [{k: [host(x) for x in v] for k, v in c.items()} for c in rec.pyramid_counts]
    launches = {k: [{a: host(b) for a, b in call.items()} for call in v]
                for k, v in rec.launches.items()}
    run = SimpleNamespace(
        kind=cell.traffic["kind"], window_s=window_s, calls=res.calls, done=res.done,
        lat=getattr(res, "lat", []),
        step_rows=list(rec.step_rows), step_valid=list(rec.step_valid),
        pyramid_s=list(rec.pyramid_s), pyramid_counts=pyr_counts, launches=launches,
        counters=dict(rec.counters), device=dict(info), trace=summary, counts=count_module,
        forward_ops=lambda c: count_module("kpfcnn").forward_ops(
            ref_model.blocks(cfg_doc, ctx.arch)[:2], c, cfg_doc["num_kernel_points"],
            cfg_doc["output_dim"]))
    out = {}
    for m in wanted:
        v = load_module("metrics", m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
