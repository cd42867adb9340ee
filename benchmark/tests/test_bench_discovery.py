"""A configuration, traffic mix, kind of traffic, limits, per-layer metric
and count added as files are found by the names in the manifest, with no
edit to the harness."""

import json

from harness import manifest, program


def test_added_files_found(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    for d in ("configs", "traffic", "kinds", "limits", "metrics", "counts"):
        (bench / d).mkdir(parents=True)
    (bench / "configs" / "m.json").write_text(json.dumps({"num_layers": 3}))
    (bench / "traffic" / "mix.json").write_text(json.dumps({"kind": "new_kind"}))
    (bench / "kinds" / "new_kind.py").write_text(
        "def run(ctx):\n    return ctx\n\n\ndef check_numbers(res, ctx):\n    return {}\n")
    (bench / "limits" / "m.mix.json").write_text(json.dumps({"desc_gap": 1.0}))
    (bench / "metrics" / "new_metric.x.py").write_text("def read(run):\n    return run * 2\n")
    (bench / "counts" / "new_kernel.py").write_text(
        "LAUNCHER = 'select.select_kernel'\nSYMBOLS = ('select_launch',)\n\n\n"
        "def sizes(args, kw):\n    return {'q': len(args)}\n\n\n"
        "def work(launch):\n    return launch['q'], 4 * launch['q']\n")
    (bench / "counts" / "model_only.py").write_text("def forward_ops():\n    return 0\n")
    m = {"command": ["python3", "benchmark/run.py"], "paths": ["benchmark"], "run_seconds": 10,
         "configs": [{"name": "m", "source": "x", "file": "benchmark/configs/m.json",
                      "reduced": [], "why": "x"}],
         "workloads": [{"name": "m.mix", "config": "m", "traffic": "mix", "chips": 1,
                        "why": "x"}],
         "end_to_end": [{"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                         "source": "host_clock"}],
         "per_layer": [{"name": "new_metric.x", "unit": "%", "better": "higher",
                        "source": "program_counter", "layer": "x", "moves": "setup_s"}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    monkeypatch.setattr(manifest, "BENCH_DIR", str(bench))
    monkeypatch.setattr(manifest, "ROOT", str(tmp_path))
    cell = manifest.load_cell("m.mix", str(tmp_path / "BENCHMARK.json"))
    assert cell.config == {"num_layers": 3} and cell.traffic == {"kind": "new_kind"}
    assert manifest.load_module("kinds", cell.traffic["kind"]).run(7) == 7
    assert cell.limits == {"desc_gap": 1.0}
    assert [p["name"] for p in cell.per_layer] == ["new_metric.x"]
    assert manifest.load_module("metrics", "new_metric.x").read(21) == 42
    assert manifest.load_module("counts", "new_kernel").work({"q": 3}) == (3, 12)
    # a count that names a launcher of the port is wrapped in a traced run
    found = program.counted_launchers()
    assert list(found) == ["new_kernel"] and found["new_kernel"].sizes((1, 2), {}) == {"q": 2}


def test_port_counters_found():
    """The port's own launch counters, found by their names, and what the
    window added to them."""
    rec = program.Recorder()
    rec.counter_fns = program.port_counter_fns()
    keys = {k for k, _, _ in rec.counter_fns}
    assert {"select.band_select.launches", "band_conv.band_conv.launches",
            "head.band_head.launches"} <= keys
    rec.clear()
    fn = next(fn for k, fn, _ in rec.counter_fns if k == "select.band_select.launches")
    fn.launches += 2
    try:
        rec.close()
    finally:
        fn.launches -= 2
    assert rec.counters["select.band_select.launches"] == 2
