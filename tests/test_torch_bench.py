"""The port's bench (``d3feat_tpu_torch/bench.py``) on the CPU at a tiny
size: its fragment draws follow ``bench.py``'s rejection loop, its JSON line
has ``bench.py``'s keys plus the card and compute dtype, it warns on
stderr when the capacities overflow, its data-parallel path (``--dp``)
gives the per-chip line in a gloo group of one, and its command line
needs a card."""

import numpy as np
import pytest

from d3feat_tpu.data.synthetic import scan_fragment as j_scan_fragment
from d3feat_tpu_torch.bench import bench_config, draw_fragments, main, run_bench
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

SCAN = dict(resolution=(24, 18))
N_MIN, N_MAX = 150, 400


@pytest.fixture(scope="module")
def fragments():
    return draw_fragments(np.random.default_rng(0), 6, N_MIN, N_MAX, **SCAN)


def test_draws_follow_the_rejection_loop(fragments):
    rng = np.random.default_rng(0)
    for got in fragments:  # bench.py:96-101
        want = j_scan_fragment(rng, **SCAN)
        while not (N_MIN <= len(want) <= N_MAX):
            want = j_scan_fragment(rng, **SCAN)
        assert np.array_equal(got, want)


def _config(bf16, caps):
    cfg = bench_config(bf16=bf16, frags=2, caps=caps, neighbors=16)
    cfg.num_layers, cfg.first_features_dim, cfg.first_subsampling_dl = 3, 16, 0.1
    return cfg


@pytest.mark.parametrize("bf16", [False, True])
def test_json_line(fragments, bf16, capsys):
    line, overflowed = run_bench(fragments, _config(bf16, (512, 256, 128)), frags=2,
                                 device="cpu", warmup=1, iters=2)
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "card", "compute_dtype"}
    assert line["metric"] == "fragment_extraction_throughput" and line["unit"] == "fragments/s"
    assert line["card"] == "cpu" and line["value"] > 0
    assert line["compute_dtype"] == ("bfloat16" if bf16 else "float32")
    assert line["vs_baseline"] == round(line["value"] / 13.7, 3)
    assert not overflowed and "WARNING" not in capsys.readouterr().err


def test_overflow_warning(fragments, capsys):
    line, overflowed = run_bench(fragments, _config(False, (512, 48, 16)), frags=2,
                                 device="cpu", warmup=1, iters=2)
    assert overflowed
    assert "WARNING: pyramid capacity overflow during bench" in capsys.readouterr().err


def test_command_line_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the bench would run")
    assert main([]) == 2
    assert main(["--dp"]) == 2


def test_dp_json_line(fragments, tmp_path):
    """``--dp``'s path at world size 1 (a gloo group of one): the per-chip
    metric with ``n_devices``, one fragment a call on two cloud slots."""
    import torch.distributed as dist

    from d3feat_tpu_torch.parallel import init_group

    init_group("cpu", world_size=1, rank=0, init_method=f"file://{tmp_path}/store",
               timeout_s=60)
    try:
        line, overflowed = run_bench(fragments, _config(False, (512, 256, 128)), frags=1,
                                     device="cpu", warmup=1, iters=2, group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "card", "compute_dtype",
                         "n_devices"}
    assert line["metric"] == "dp_fragment_extraction_throughput_per_chip"
    assert line["n_devices"] == 1 and line["value"] > 0 and line["card"] == "cpu"
    assert not overflowed
