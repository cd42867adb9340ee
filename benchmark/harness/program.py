"""The program under test, the port ``d3feat_tpu_torch``: its configuration
built from a cell's configuration file, its model loaded with the weights
the benchmark made, its extraction and train-step entries, and the spans
and counters the benchmark places around the calls into its layers.

Spans are the benchmark's own: each wraps a module attribute of the port
through which the port itself calls a layer (``train/step.py``'s
``build_pyramid``, ``eval/extract.py``'s ``pack_fragments``, the launchers
of ``ops/*.py`` that a count file names, and ``ops/build.py``'s
``launcher``, which binds every foreign launch function), so every call
of that layer on the timed path passes through it. Outside a traced run
only the pyramid's wrapper is installed, and it only counts the rows
handed to each step and keeps the pyramid of the calls the check samples.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch

from d3feat_tpu_torch.config import D3FeatConfig


def make_config(doc: dict, compute_dtype: str = None) -> D3FeatConfig:
    """The port's configuration of a configuration file: its
    ``D3FeatConfig`` fields, with the file's ``architecture`` list when it
    states one (a subclass of the port's ``D3FeatConfig``)."""
    arch = doc.get("architecture")

    class BenchConfig(D3FeatConfig):
        def architecture(self):
            return list(arch) if arch else D3FeatConfig.architecture(self)

    known = {f.name for f in dataclasses.fields(D3FeatConfig)}
    cfg = BenchConfig.from_dict({k: v for k, v in doc.items() if k in known})
    if compute_dtype:
        cfg.compute_dtype = compute_dtype
    return cfg


def _kpfcnn(cfg, device):
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn

    return init_kpfcnn(cfg, device=device)


def _kpcnn(cfg, device):
    from d3feat_tpu_torch.models.kpcnn import init_kpcnn, make_kpcnn_specs

    return init_kpcnn(cfg, device=device, specs=make_kpcnn_specs(cfg, cfg.architecture()))


NETWORKS = {"kpfcnn": _kpfcnn, "kpcnn": _kpcnn}


def build_model(cfg, network: str, weight_rule: dict, seed: int, device, root: str):
    """(the port's model of ``cfg``, the weights it holds): the network a
    configuration names (``NETWORKS``), the weights made by the benchmark
    (``reference.weights.make_weights``) for the model's leaves and loaded
    strictly."""
    from reference.weights import make_weights

    if network not in NETWORKS:
        raise ValueError(f"network {network!r}: the benchmark builds {sorted(NETWORKS)}")
    model = NETWORKS[network](cfg, device)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    weights = make_weights(weight_rule, shapes, seed, device, root)
    model.load_state_dict({k: v.clone() for k, v in weights.items()}, strict=True)
    return model, weights


@dataclasses.dataclass
class Recorder:
    """What the wrappers collected: the kept pyramid, the rows handed to
    each step, and in a traced run the pyramid spans' seconds, each
    pyramid's valid rows and listed pairs, the sizes of each call of a
    launcher that a count file names (``launches``, by the count's name),
    and each foreign launch of the port with its CUDA events
    (``timed``). ``counters`` holds what the port's own ``launches``
    counters added in the window. Device tensors are read after the
    window."""

    tracing: bool = False
    keep: bool = False
    kept: dict = None
    valid_rows: int = 0
    step_rows: list = dataclasses.field(default_factory=list)
    step_valid: list = dataclasses.field(default_factory=list)
    pyramid_s: list = dataclasses.field(default_factory=list)
    pyramid_counts: list = dataclasses.field(default_factory=list)
    launches: dict = dataclasses.field(default_factory=lambda: collections.defaultdict(list))
    timed: list = dataclasses.field(default_factory=list)
    origin: object = None
    counter_fns: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)

    def _counts(self) -> dict:
        return {key: getattr(fn, attr) for key, fn, attr in self.counter_fns}

    def clear(self):
        """Forget what set-up recorded: the window's own records only."""
        for rows in (self.step_rows, self.step_valid, self.pyramid_s, self.pyramid_counts,
                     self.timed):
            rows.clear()
        self.launches.clear()
        self.counters = self._counts()

    def close(self):
        """The window has closed: what the port's counters added in it."""
        start = self.counters
        self.counters = {k: v - start.get(k, 0) for k, v in self._counts().items()}


def port_counter_fns() -> list:
    """(``<module>.<function>.<counter>``, function, counter) of every
    ``launches*`` counter that a function of the port's ``ops`` package
    keeps, its modules imported."""
    import importlib
    import pkgutil

    import d3feat_tpu_torch.ops as ops

    out = []
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        for name, fn in sorted(vars(mod).items()):
            if callable(fn) and getattr(fn, "__module__", None) == mod.__name__:
                for attr, v in sorted(getattr(fn, "__dict__", {}).items()):
                    if attr.startswith("launches") and isinstance(v, int):
                        out.append((f"{info.name}.{name}.{attr}", fn, attr))
    return out


def _pyramid_counts(pyr) -> dict:
    """Valid rows of each level and listed pairs of each search."""
    shadow = [p.shape[0] for p in pyr["points"]]
    return {"rows": [ln.sum() for ln in pyr["lengths"]],
            "conv": [(n < shadow[l]).sum() for l, n in enumerate(pyr["neighbors"])],
            "pool": [(n < shadow[l]).sum() for l, n in enumerate(pyr["pools"])]}


def keep_pyramid(pyr) -> dict:
    """The parts of a pyramid the check reads (references, no copies)."""
    band = pyr.get("band") or {}
    return {"points": list(pyr["points"]), "lengths": list(pyr["lengths"]),
            "neighbors": list(pyr["neighbors"]), "pools": list(pyr["pools"]),
            "upsamples": list(pyr["upsamples"]), "masks": list(pyr["masks"]),
            "order": band[0]["order"] if 0 in band else None}


def counted_launchers() -> dict:
    """``{count name: count module}`` of the count files
    (``counts/<name>.py``) that name a launcher of the port: ``LAUNCHER``
    (``"<module of ops>.<function>"``), ``SYMBOLS`` (its foreign launch
    functions, whose device time is the kernel's), ``sizes(args, kw)``
    (a call's sizes, from its arguments) and ``work(sizes)``."""
    import glob
    import os

    from harness.manifest import BENCH_DIR, load_module

    out = {}
    for path in sorted(glob.glob(os.path.join(BENCH_DIR, "counts", "*.py"))):
        name = os.path.basename(path)[:-3]
        mod = load_module("counts", name)
        if hasattr(mod, "LAUNCHER"):
            out[name] = mod
    return out


@contextlib.contextmanager
def spans(rec: Recorder):
    """Install the benchmark's wrappers on the port for the block's
    duration. Always: the pyramid's, which counts the rows handed to each
    step and keeps the pyramid of the calls the check samples. With
    ``rec.tracing`` also: the pyramid's and the packing's spans; each call
    of a launcher that a count file names records its sizes; and every
    foreign launch function the port binds (``ops/build.py::launcher``) is
    timed by CUDA events recorded on the stream right before and after the
    foreign call, so the launchers' Python (checks, allocations, fills) is
    host time and not the kernel's."""
    import importlib

    from torch.profiler import record_function

    import d3feat_tpu_torch.eval.extract as extract
    import d3feat_tpu_torch.ops.build as build
    import d3feat_tpu_torch.train.step as step

    rec.counter_fns = port_counter_fns()
    counted = counted_launchers() if rec.tracing else {}
    wrapped = []
    for cname, count in counted.items():
        mname, fname = count.LAUNCHER.rsplit(".", 1)
        wrapped.append((cname, count, importlib.import_module(f"d3feat_tpu_torch.ops.{mname}"),
                        fname))
    saved = [(step, "build_pyramid", step.build_pyramid),
             (extract, "pack_fragments", extract.pack_fragments),
             (build, "launcher", build.launcher)]
    saved += [(mod, f, getattr(mod, f)) for _, _, mod, f in wrapped]
    orig_pyr, orig_pack, orig_launcher = step.build_pyramid, extract.pack_fragments, \
        build.launcher
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)

    def build_pyramid(points, lengths, **kw):
        rec.step_rows.append(points.shape[0])
        rec.step_valid.append(rec.valid_rows)
        if rec.tracing:
            sync()
            t = time.perf_counter()
            with record_function("bench.pyramid"):
                pyr = orig_pyr(points, lengths, **kw)
            sync()
            rec.pyramid_s.append(time.perf_counter() - t)
            rec.pyramid_counts.append(_pyramid_counts(pyr))
        else:
            pyr = orig_pyr(points, lengths, **kw)
        if rec.keep:
            rec.kept = keep_pyramid(pyr)
        return pyr

    def pack_fragments(*args, **kw):
        with record_function("bench.pack"):
            return orig_pack(*args, **kw)

    def sized(cname, count, orig):
        def call(*args, **kw):
            rec.launches[cname].append(count.sizes(args, kw))
            return orig(*args, **kw)
        return call

    def launcher(name, symbol, argtypes):
        fn = orig_launcher(name, symbol, argtypes)

        def timed(*args):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            rc = fn(*args)
            ev[1].record()
            rec.timed.append((symbol, ev))
            return rc
        return timed

    step.build_pyramid = build_pyramid
    if rec.tracing:
        extract.pack_fragments = pack_fragments
        for cname, count, mod, f in wrapped:
            setattr(mod, f, sized(cname, count, getattr(mod, f)))
        if torch.cuda.is_available():
            build.launcher = launcher
    try:
        yield rec
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def port_kernel_names() -> set:
    """The ``__global__`` kernels of the port's CUDA sources
    (``ops/cuda/*.cu``, ``*.cuh``): the names its profiler events carry."""
    import glob
    import os
    import re

    import d3feat_tpu_torch

    cuda = os.path.join(os.path.dirname(d3feat_tpu_torch.__file__), "ops", "cuda")
    names = set()
    for path in glob.glob(os.path.join(cuda, "*.cu*")):
        with open(path) as f:
            names |= set(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(",
                f.read()))
    return names


def launch_intervals(rec: Recorder) -> list:
    """(foreign launch function, start, end) of each timed launch, seconds
    after ``rec.origin`` on the device (synchronised first)."""
    return [(name, rec.origin.elapsed_time(a) * 1e-3, rec.origin.elapsed_time(b) * 1e-3)
            for name, (a, b) in rec.timed]


def to_host(x):
    """Device tensors (nested in lists and dicts) to numpy, ints to ints."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_host(v) for v in x]
    return x


def extractor(cfg, model, spec: dict, device):
    """The port's ``FeatureExtractor`` as the mix asks for it."""
    from d3feat_tpu_torch.eval.extract import FeatureExtractor

    return FeatureExtractor(cfg, model, buckets=tuple(spec["buckets"]),
                            batch_fragments=int(spec["batch_fragments"]),
                            on_overflow=spec["on_overflow"], device=device)


class Trainer:
    """The port's train step on one packed pair a step: set-up builds the
    optimizer and the step once (``mark`` closes each part of set-up);
    ``feed`` packs a pair with the port's ``data/pack.py`` and copies it to
    the card, as the port's loader would, and runs the step."""

    def __init__(self, cfg, model, device, mark=lambda name: None):
        from d3feat_tpu_torch.train.optim import make_optimizer
        from d3feat_tpu_torch.train.step import TrainState, make_train_step

        self.cfg, self.device = cfg, device
        optimizer = make_optimizer(cfg, model)
        mark("make_optimizer")
        self.state = TrainState(model, optimizer)
        self.step = make_train_step(cfg)
        mark("make_train_step")
        self.names = {id(t): n for n, t in model.state_dict(keep_vars=True).items()}

    def pack(self, pair):
        from d3feat_tpu_torch.data.pack import pack_pair

        p0, p1, corr, dk = pair
        return pack_pair(p0, p1, np.ones((len(p0), 1), np.float32),
                         np.ones((len(p1), 1), np.float32), corr, dk,
                         point_capacity=self.cfg.caps.points[0],
                         corr_capacity=self.cfg.caps.corr)

    def feed(self, pair):
        from torch.profiler import record_function

        with record_function("bench.pack"):
            packed = self.pack(pair)
            batch = {k: torch.from_numpy(np.asarray(getattr(packed, k))).to(self.device)
                     for k in packed._fields}
        self.state, metrics = self.step(self.state, batch, 0)
        return packed, metrics

    def params(self) -> dict:
        """``{name: host copy}`` of the model's parameters."""
        return {n: t.detach().to("cpu", copy=True)
                for n, t in self.state.model.named_parameters()}

    def momentum(self) -> dict:
        """``{name: host copy}`` of the optimizer's momentum buffers (none
        before the first step; after it, the gradient plus weight decay as
        the optimizer got it)."""
        out = {}
        for t, st in self.state.optimizer.state.items():
            if "momentum_buffer" in st and st["momentum_buffer"] is not None:
                out[self.names[id(t)]] = st["momentum_buffer"].detach().to("cpu", copy=True)
        return out
