"""CLI driver tests (argument surface parity with frontend.rs:52-75)."""

import io
import pickle
import sys

import numpy as np
import pytest

from spada_tpu.cli import build_parser, main
from spada_tpu.io.workloads import random_csr


def _run(argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, out


def test_parser_shape():
    args = build_parser().parse_args(
        ["run", "spada", "SS", "cari", "config/default.json", "-p"]
    )
    assert args.mode == "run" and args.dataflow == "spada"
    assert args.preprocess


def test_traffic_mode_cari(capsys):
    rc, out = _run(["traffic", "rowwise", "SS", "cari", "config/default.json",
                    "--no-result"], capsys)
    assert rc == 0
    assert "b_reuse" in out and "miss_count" in out


def test_breuse_mode(capsys):
    rc, out = _run(["breuse", "rowwise", "SS", "cari"], capsys)
    assert rc == 0
    assert "b_reuse" in out and "cache hit ratio" in out


def test_plan_mode(capsys):
    rc, out = _run(["plan", "spada", "SS", "cari"], capsys)
    assert rc == 0
    assert "tm histogram" in out


def test_run_mode_small_nn(tmp_path, capsys):
    """End-to-end run mode on a small pickled NN gemm (XLA CPU engine)."""
    a = random_csr(64, 96, 0.1, seed=0).to_scipy()
    b = random_csr(96, 64, 0.1, seed=1).to_scipy()
    pkl = tmp_path / "nn.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"layer0": (a, b)}, f)
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"nn_filepath": "%s"}' % pkl)
    rc, out = _run(["run", "spada", "NN", "layer0", str(cfg)], capsys)
    assert rc == 0
    assert "GFLOP/s" in out and "C[0]" in out


def test_run_mode_preprocessed_restores_rows(tmp_path, capsys):
    """-p must not change the printed result rows (row ids restored)."""
    rng = np.random.default_rng(2)
    a = random_csr(48, 48, 0.15, seed=3).to_scipy()
    pkl = tmp_path / "nn.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"g": (a, a)}, f)
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"nn_filepath": "%s"}' % pkl)
    _, out_plain = _run(["run", "ip", "NN", "g", str(cfg)], capsys)
    _, out_pre = _run(["run", "ip", "NN", "g", str(cfg), "-p"], capsys)
    rows_plain = [l for l in out_plain.splitlines() if l.startswith("  C[")]
    rows_pre = [l for l in out_pre.splitlines() if l.startswith("  C[")]
    assert rows_plain == rows_pre


def test_nn_autogenerate_out_of_the_box(tmp_path, capsys):
    """`run spada NN <layer>` generates the stock pickle when missing
    (the NN category end to end without manual setup)."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"nn_filepath": "%s"}' % (tmp_path / "nn_gemm.pkl"))
    rc, out = _run(["run", "spada", "NN", "resnet50_fc", str(cfg),
                    "--no-result"], capsys)
    assert rc == 0
    assert "generating NN workloads" in out
    assert (tmp_path / "nn_gemm.pkl").exists()
    # second run reuses the pickle
    rc, out = _run(["run", "spada", "NN", "resnet50_fc", str(cfg),
                    "--no-result"], capsys)
    assert rc == 0
    assert "generating NN workloads" not in out


def test_plan_scheme_profiled_cli(capsys):
    """--plan-scheme profiled reaches the measured-latency planner
    (the scheme-3 signal exposed beyond tests)."""
    rc, out = _run(["plan", "spada", "SS", "cari", "--plan-scheme",
                    "profiled"], capsys)
    assert rc == 0
    assert "scheme profiled" in out


def test_op_dataflow_colwise_plan_cli(capsys):
    """op dataflow prints and uses the colwise (scheme 1/2) panel plan."""
    rc, out = _run(["run", "op", "SS", "cari", "--no-result"], capsys)
    assert rc == 0
    assert "colwise plan" in out


def test_run_mode_densify_prints_decision(tmp_path, capsys):
    """--densify auto (default) prints the layout decision; a scattered
    pickled GEMM under element_dispatch=never exercises the tile path."""
    import json

    from spada_tpu.io.workloads import rmat_csr

    a = rmat_csr(256, 6.0, seed=80, dtype=np.float64).to_scipy()
    pkl = tmp_path / "nn.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"g": (a, a)}, f)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "nn_filepath": str(pkl), "element_dispatch": "never",
        "tile_k": 128, "tile_n": 128,
    }))
    rc, out = _run(["run", "spada", "NN", "g", str(cfg), "--no-result"],
                   capsys)
    assert rc == 0
    assert "densify:" in out

    rc2, out2 = _run(["run", "spada", "NN", "g", str(cfg), "--no-result",
                      "--densify", "off"], capsys)
    assert rc2 == 0
    assert "densify:" not in out2
