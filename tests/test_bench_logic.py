"""Host-side logic of bench.py's variance handling (no device needed):
the two-pass re-time keeps the better %-of-SoL and reports both passes."""

import sys
import os

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from spada_tpu.config import SpadaConfig  # noqa: E402


def test_second_pass_keeps_better_pct(monkeypatch):
    calls = {"n": 0}

    def fake_stats(fn, args, k=8, trials=3):
        calls["n"] += 1
        return 0.001, [0.001]  # pass 2 measures 1.0 ms

    import spada_tpu.utils.timing as timing

    monkeypatch.setattr(timing, "device_time_stats", fake_stats)

    entries = [
        {   # slower first pass: second pass (1.0 ms vs sol 0.8) wins
            "name": "w1", "pct_sol": 40.0, "elapsed_ms": 2.0,
            "pct_sol_unique": 20.0, "effective_gflops": 1.0,
            "_retime": (lambda *a: None, (), {
                "sol_s": 0.0008, "sol_unique_s": 0.0004,
                "flops": 2e9}),
        },
        {   # faster first pass: keeps its numbers
            "name": "w2", "pct_sol": 95.0, "elapsed_ms": 0.8421,
            "stream_gbps": 700.0,
            "_retime": (lambda *a: None, (), {"sol_s": 0.0008}),
        },
        {"name": "w3", "error": "entry failed: infra"},  # no retime
    ]
    bench._second_pass(entries, SpadaConfig())

    assert entries[0]["pct_sol"] == 80.0
    assert entries[0]["elapsed_ms"] == 1.0
    assert entries[0]["pct_sol_unique"] == 40.0
    assert entries[0]["effective_gflops"] == 2000.0
    assert entries[0]["passes"] == [40.0, 80.0]

    assert entries[1]["pct_sol"] == 95.0           # pass 2 (80) lost
    assert entries[1]["elapsed_ms"] == 0.8421
    assert entries[1]["passes"] == [95.0, 80.0]

    assert "passes" not in entries[2]
    assert calls["n"] == 2


def test_cached_workload_roundtrip(tmp_path, monkeypatch):
    """Disk-cached workloads reload exactly and never re-call the builder."""
    import os

    import bench as bmod
    from spada_tpu.io.workloads import banded_csr

    monkeypatch.setattr(bmod, "_CACHE_ROOT", str(tmp_path))
    m1 = bmod._cached_workload(
        "t-wl", lambda: banded_csr(256, 256, bandwidth=16, seed=0,
                                   dtype=np.float32))
    m2 = bmod._cached_workload(
        "t-wl", lambda: (_ for _ in ()).throw(
            AssertionError("builder re-called on cache hit")))
    assert m1.shape == m2.shape
    assert np.array_equal(m1.indptr, m2.indptr)
    assert np.array_equal(m1.indices, m2.indices)
    assert np.array_equal(m1.data, m2.data)
    assert os.path.exists(tmp_path / ".bench_cache" / "v1-t-wl.npz")


def test_spread_ms_clamps_negative():
    assert bench._spread_ms([-0.001, 0.002]) == [0.0, 2.0]
    assert bench._spread_ms([0.001, 0.003]) == [1.0, 3.0]


def test_second_pass_updates_pct_binding(monkeypatch):
    import spada_tpu.utils.timing as timing

    monkeypatch.setattr(timing, "device_time_stats",
                        lambda *a, **k: (0.001, [0.001]))
    entries = [
        {   # tile entry: binding recomputed from sol_unique, capped at 100
            "name": "t", "pct_sol": 40.0, "pct_binding": 20.0,
            "elapsed_ms": 2.0, "pct_sol_unique": 20.0,
            "effective_gflops": 1.0,
            "_retime": (lambda *a: None, (), {
                "sol_s": 0.0008, "sol_unique_s": 0.0004,
                "flops": 2e9}),
        },
        {   # element entry: binding == capped pct_sol
            "name": "e", "pct_sol": 50.0, "pct_binding": 50.0,
            "elapsed_ms": 2.4, "stream_gbps": 400.0,
            "_retime": (lambda *a: None, (), {"sol_s": 0.0012}),
        },
    ]
    bench._second_pass(entries, SpadaConfig())
    assert entries[0]["pct_binding"] == 40.0
    assert entries[1]["pct_sol"] == 120.0     # naive can exceed 100...
    assert entries[1]["pct_binding"] == 100.0  # ...binding is capped


def test_summarize_compact_and_parseable():
    """The stdout line must parse and stay compact (the driver's record);
    the bulk goes to the detail dict."""
    import json

    entries = [
        {"name": "w1", "engine": "triton", "elapsed_ms": 2.0,
         "pct_sol": 105.0, "pct_binding": 88.0,
         "densify_w_model": {"big": list(range(100))}},
        {"name": "w2", "engine": "element", "elapsed_ms": 1.0,
         "pct_sol": 83.0, "pct_binding": 83.0},
        {"name": "w3", "engine": "triton", "elapsed_ms": 3.0,
         "pct_sol": 90.0, "pct_binding": 68.0},
        {"name": "w4", "error": "entry failed: infra " + "x" * 300},
    ]
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    summary, detail = bench._summarize(entries, {"name": "cari"},
                                       {"cal_r2w1_gbps": 650.0}, dev)
    line = json.dumps(summary)
    parsed = json.loads(line)
    assert parsed["metric"] == "spgemm_pct_binding"
    assert parsed["value"] == 83.0          # median of pct_binding
    assert parsed["value_naive"] == 90.0    # median of pct_sol
    assert parsed["vs_baseline"] == round(83.0 / 70.0, 4)
    assert len(line) < 4000                 # compact: parser-safe
    assert len(parsed["suite"]) == 4
    assert parsed["suite"][3]["error"].startswith("entry failed")
    assert detail["suite"][0]["densify_w_model"]["big"][99] == 99
    assert parsed["device"] == dev


def test_summarize_gate_failure_zeroes():
    entries = [
        {"name": "w1", "pct_sol": 90.0, "pct_binding": 80.0},
        {"name": "w2", "pct_sol": 85.0, "pct_binding": 75.0},
        {"name": "w3", "pct_sol": 80.0, "pct_binding": 70.0},
        {"name": "bad", "error": "kernel gate failed (relerr=1e-1)"},
    ]
    summary, _ = bench._summarize(entries, {}, {}, {})
    assert summary["value"] == 0.0
    assert summary["value_naive"] == 0.0

    # infra failure with >=3 survivors keeps the median
    entries[3] = {"name": "w4", "error": "entry failed: compile"}
    summary, _ = bench._summarize(entries, {}, {}, {})
    assert summary["value"] == 75.0


def test_entry_dispatched_routes_both_ways(monkeypatch):
    """_entry_dispatched routes through dispatch_dataflow (bf16-true
    modeling) and tags the entry with the decision + modeled times."""
    from spada_tpu.io.workloads import block_sparse_csr, powerlaw_csr

    monkeypatch.setattr(bench, "_tile_entry",
                        lambda name, *a, **k: {"name": name,
                                               "engine": "triton"})
    monkeypatch.setattr(bench, "_element_entry",
                        lambda name, *a, **k: {"name": name,
                                               "engine": "element"})
    cfg = SpadaConfig()
    a = block_sparse_csr(2048, 2048, 128, 0.4, seed=70, dtype=np.float32)
    out = bench._entry_dispatched("clustered", a, a, cfg, peaks=None)
    assert out["dispatch"] == "tile" and out["engine"] == "triton"
    assert set(out["dispatch_t_est_ms"]) == {"element", "tile"}
    s = powerlaw_csr(4096, 4096, 4.0, seed=71, dtype=np.float32)
    out = bench._entry_dispatched("scattered", s, s, cfg, peaks=None)
    assert out["dispatch"] == "element" and out["engine"] == "element"


def test_bench_fails_without_gpu(monkeypatch):
    """The measurement child refuses to run off the GPU instead of
    falling back to a CPU number."""
    import pytest

    with pytest.raises(RuntimeError, match="GPU"):
        bench.main()
