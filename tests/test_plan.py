"""Planner-layer tests: group parsing, topology queries, sequential policies
(golden pure-logic tests per SURVEY.md §4), analytic planner + mixed-height
execution vs the scipy oracle."""

import numpy as np
import pytest

from spada_tpu.config import SpadaConfig
from spada_tpu.io.workloads import powerlaw_csr, random_csr
from spada_tpu.plan.estimator import (
    BTileStructure,
    expected_merged_row_nnz,
    max_cachable_rows,
    panel_cost_model,
)
from spada_tpu.plan.groups import parse_group
from spada_tpu.plan.planner import execute_plan, plan_spgemm
from spada_tpu.plan.policy import (
    BlockFeedback,
    ColwiseIrrPolicy,
    ColwiseRegPolicy,
    RowwiseCostPolicy,
    RowwiseLatencyPolicy,
    traffic_cost,
)
from spada_tpu.plan.topo import BlockTopoTracker


# ---------------- groups ----------------

def test_parse_group_uniform():
    gt = parse_group(np.full(100, 7), var_factor=1.5)
    assert gt.n_groups == 1
    assert gt.groups[0].row_range == (0, 100)
    assert gt.groups[0].avg_row_len == 7


def test_parse_group_jump():
    lens = np.array([4, 4, 4, 10, 10, 10])  # 4*1.5 < 10 -> boundary at row 3
    gt = parse_group(lens, 1.5)
    assert [g.row_range for g in gt.groups] == [(0, 3), (3, 6)]
    assert gt.group_of(2) == 0 and gt.group_of(3) == 1


def test_parse_group_zero_rows_do_not_split():
    lens = np.array([4, 0, 0, 5, 4, 0, 6])  # within 1.5x band across zeros
    gt = parse_group(lens, 1.5)
    assert gt.n_groups == 1


def test_parse_group_drop():
    lens = np.array([9, 9, 4])  # 9 > 1.5*4 -> boundary at row 2
    gt = parse_group(lens, 1.5)
    assert [g.row_range for g in gt.groups] == [(0, 2), (2, 3)]


def test_parse_group_avg_includes_empty_rows():
    lens = np.array([6, 0, 0, 6])
    gt = parse_group(lens, 1.5)
    assert gt.groups[0].avg_row_len == 12 // 4  # integer div over all rows


# ---------------- topo ----------------

def test_topo_left_and_above():
    t = BlockTopoTracker()
    t.add_block(0, 0, 0)
    t.add_block(1, 0, 8)
    t.add_block(2, 8, 0)
    # left of (8, 8) -> token 2 at (8, 0)
    assert t.find_left(8, 8)[0] == 2
    # left of (8, 0): no column strictly left of 0 in any band
    assert t.find_left(8, 0) is None
    # above (8, 4): row band 0, nearest col to 4 of {0, 8} -> 0 (ties go left)
    assert t.find_above(8, 4)[0] == 0
    assert t.find_above(8, 5)[0] == 1
    assert t.find_above(0, 0) is None
    assert BlockTopoTracker().find_left(0, 0) is None


# ---------------- sequential policies ----------------

def test_rowwise_latency_sampling_then_commit():
    # one wide group (400 rows, uniform lens) -> sampling schedule then commit
    lens = np.full(400, 10)
    pol = RowwiseLatencyPolicy(8, lens, lens)
    h = pol.adjust_block_shape(0, 1)
    assert h == 1  # group entry resets to 1
    # feed feedback: height h costs 100/h per element (bigger is better)
    gi = pol.a_group.groups[0]
    for height in (1, 2, 4, 8):
        gi.cost_num[height] = [100 // height, 1]
    pol.row_group = 0
    pol.sampling_bounds = [5, 13, 29, 61]
    # during sampling: height depends on position
    assert pol.adjust_block_shape(4, 1) == 1
    assert pol.adjust_block_shape(5, 1) == 2
    assert pol.adjust_block_shape(20, 2) == 4
    # after the last bound: commit to argmin cost/ele = 8
    assert pol.adjust_block_shape(100, 4) == 8
    assert pol.set_row_num == 8


def test_rowwise_latency_narrow_group_growth():
    lens = np.full(50, 10)  # narrow group (< group_diviser)
    pol = RowwiseLatencyPolicy(8, lens, lens)
    pol.adjust_block_shape(0, 1)
    gi = pol.a_group.groups[0]
    gi.cost_num[1] = [100, 10]
    # no half-height data -> grow
    assert pol.adjust_block_shape(1, 1) == 2
    gi.cost_num[2] = [50, 10]  # improved -> keep growing
    assert pol.adjust_block_shape(3, 2) == 4
    gi.cost_num[4] = [80, 10]  # worse than half -> commit argmin (=2)
    assert pol.adjust_block_shape(7, 4) == 2


def test_rowwise_cost_narrow_hill_climb():
    lens = np.full(50, 10)
    pol = RowwiseCostPolicy(8, lens, lens)
    pol.adjust_block_shape(0, 0, 0, 1, BlockTopoTracker(), lens)  # enter group
    topo = BlockTopoTracker()
    topo.add_block(0, 0, 0)   # block at rows 0.. (2 rows)
    topo.add_block(1, 2, 0)   # block at rows 2.. (4 rows)
    pol.block_info[0] = BlockFeedback(a_ele_num=20, cost=2000)
    pol.block_info[1] = BlockFeedback(a_ele_num=40, cost=1000)
    # recent block (rows 2-6, 4 rows) cheaper per element and taller -> grow
    h = pol.adjust_block_shape(6, 0, 6, 4, topo, lens)
    assert h == 8
    # make recent block worse -> shrink
    pol.block_info[1] = BlockFeedback(a_ele_num=40, cost=100000)
    h = pol.adjust_block_shape(6, 0, 6, 4, topo, lens)
    assert h == 2


def test_colwise_reg_window_adjust():
    pol = ColwiseRegPolicy(8)
    assert pol.adjust_block_shape(0, 400) == (8, 8)
    topo = BlockTopoTracker()
    # no neighbors: full lane window clamped to block height
    assert pol.adjust_window_shape(0, 0, 0, 8, topo) == (8, 1)
    topo.add_block(0, 0, 0)
    # one neighbor: lane_num/2
    assert pol.adjust_window_shape(1, 0, 8, 8, topo) == (4, 2)
    topo.add_block(1, 0, 8)
    pol.block_info[0] = BlockFeedback(a_ele_num=10, cost=1000)
    pol.block_info[1] = BlockFeedback(a_ele_num=10, cost=500)
    # n1 (token 1) cheaper and its window (4) >= n2's (8)? h1=4 < h2=8 -> halve
    h = pol.adjust_window_shape(2, 0, 16, 8, topo)
    assert h == (2, 4)


def test_colwise_irr_degrade_only():
    pol = ColwiseIrrPolicy(lane_num=8, group_size=16, block_width=8)
    topo = BlockTopoTracker()
    s0 = pol.adjust_block_shape(0, 0, 400, topo)
    assert s0 == (8, 8)
    topo.add_block(0, 0, 0)
    s1 = pol.adjust_block_shape(0, 8, 400, topo)
    assert s1 == (4, 8)  # second block: lane_num/2
    topo.add_block(1, 0, 8)
    pol.block_info[0] = BlockFeedback(a_ele_num=10, cost=1000)
    pol.block_info[1] = BlockFeedback(a_ele_num=10, cost=100)
    s2 = pol.adjust_block_shape(0, 16, 400, topo)
    assert s2 == (2, 8)  # left cheaper -> halve
    # non-boundary anchors reuse the group shape
    assert pol.adjust_block_shape(3, 24, 400, topo) == s2


def test_traffic_cost_metric():
    assert traffic_cost(7, 3, 42) == (7 + 3) * 100 + 42


# ---------------- estimator ----------------

def test_expected_merged_row_nnz_bounds():
    lens = np.full(100, 50)
    gt = parse_group(lens, 1.5)
    # touching many dense-ish rows -> close to b_width; one row -> ~avg len
    one = expected_merged_row_nnz(np.array([0]), gt, 1000)
    many = expected_merged_row_nnz(np.arange(100), gt, 1000)
    assert 45 <= one <= 50.01
    assert many > one
    assert many <= 1000


def test_max_cachable_rows_monotone():
    a = random_csr(64, 64, 0.3, seed=30)
    gt = parse_group(a.row_lens(), 1.5)
    small = max_cachable_rows(a, 0, gt, 64, budget_words=64, max_rows=64)
    big = max_cachable_rows(a, 0, gt, 64, budget_words=100000, max_rows=64)
    assert small <= big
    assert big >= 1


def test_panel_cost_model_matches_worklist():
    from spada_tpu.ops.worklist import build_worklist
    from spada_tpu.sparse.bsr import BsrMatrix

    a = powerlaw_csr(200, 300, 6.0, seed=31)
    b = random_csr(300, 250, 0.04, seed=32)
    bt = BTileStructure(b)
    for tm in (8, 32, 128):
        est = panel_cost_model(a, 0, a.row_num, tm, bt)
        wl = build_worklist(
            BsrMatrix.from_csr(a, tm, 128), BsrMatrix.from_csr(b, 128, 128)
        )
        assert est["work"] == wl.n_items
        assert est["c_tiles"] == wl.n_c_tiles


# ---------------- planner + execution ----------------

def _oracle(a, b):
    return (a.to_scipy() @ b.to_scipy()).toarray().astype(np.float32)


def test_plan_and_execute_powerlaw():
    a = powerlaw_csr(500, 300, 8.0, seed=33)
    b = random_csr(300, 400, 0.05, seed=34)
    cfg = SpadaConfig()
    plan = plan_spgemm(a, b, cfg)
    assert sum(p.row_end - p.row_start for p in plan.panels) == a.row_num
    res = execute_plan(a, b, plan, cfg)
    np.testing.assert_allclose(res.todense(), _oracle(a, b), rtol=1e-4, atol=1e-5)


def test_plan_mixed_heights_beat_or_match_worst_fixed():
    # a matrix with a dense band and a sparse tail: plan should pick
    # different heights per region and its modeled bytes should be <= the
    # worst uniform choice
    dense = random_csr(128, 256, 0.4, seed=35)
    sparse = powerlaw_csr(384, 256, 2.0, seed=36)
    import scipy.sparse as sp

    a_s = sp.vstack([dense.to_scipy(), sparse.to_scipy()]).tocsr()
    from spada_tpu.sparse.csr import CsrMatrix

    a = CsrMatrix.from_scipy(a_s)
    b = random_csr(256, 256, 0.05, seed=37)
    cfg = SpadaConfig()
    plan = plan_spgemm(a, b, cfg)
    res = execute_plan(a, b, plan, cfg)
    np.testing.assert_allclose(res.todense(), _oracle(a, b), rtol=1e-4, atol=1e-5)
    bt = BTileStructure(b)
    plan_bytes = sum(
        panel_cost_model(a, p.row_start, p.row_end, p.tm, bt)["bytes"]
        for p in plan.panels
    )
    worst = max(
        panel_cost_model(a, 0, a.row_num, tm, bt)["bytes"]
        for tm in cfg.tm_choices
    )
    assert plan_bytes <= worst


def test_spgemm_with_plan_api(cari_workload):
    from spada_tpu.ops import spgemm

    w = cari_workload
    plan = plan_spgemm(w.a, w.b)
    res = spgemm(w.a, w.b, dataflow="spada", plan=plan)
    ref = w.reference_product().toarray().astype(np.float32)
    np.testing.assert_allclose(res.todense(), ref, rtol=1e-3, atol=1e-3)


def test_profiled_plan_uses_measure():
    a = powerlaw_csr(600, 200, 5.0, seed=38)
    b = random_csr(200, 200, 0.05, seed=39)
    calls = []

    def fake_measure(s, e, tm):
        calls.append((s, e, tm))
        return 1.0 / tm  # bigger panels always "faster"

    plan = plan_spgemm(a, b, scheme="profiled", measure=fake_measure)
    assert calls
    assert all(p.tm == 128 for p in plan.panels)


def test_profiled_scheme_with_default_measure():
    from spada_tpu.io.workloads import powerlaw_csr, random_csr
    from spada_tpu.plan.planner import (execute_plan, make_profiled_measure,
                                        plan_spgemm)

    a = powerlaw_csr(200, 128, 6.0, seed=50)
    b = random_csr(128, 160, 0.1, seed=51)
    measure = make_profiled_measure(a, b)
    plan = plan_spgemm(a, b, scheme="profiled", measure=measure)
    assert plan.meta["scheme"] == "profiled"
    res = execute_plan(a, b, plan)
    ref = np.asarray((a.to_scipy() @ b.to_scipy()).todense())
    np.testing.assert_allclose(res.todense(), ref, rtol=1e-4, atol=1e-4)


def test_segment_trace_records():
    from spada_tpu.io.workloads import random_csr
    from spada_tpu.plan.planner import plan_spgemm, execute_plan
    from spada_tpu.utils import trace

    a = random_csr(100, 80, 0.1, seed=52)
    b = random_csr(80, 100, 0.1, seed=53)
    trace.clear()
    trace.enable(True)
    try:
        execute_plan(a, b, plan_spgemm(a, b))
        recs = trace.records("segment")
        assert len(recs) >= 1
        assert all("dur_s" in r and "work_items" in r for r in recs)
    finally:
        trace.enable(False)
        trace.clear()


def test_choose_tile_size():
    from spada_tpu.config import SpadaConfig
    from spada_tpu.io.workloads import banded_csr, random_csr
    from spada_tpu.plan.planner import choose_tile_size

    # dense-ish banded structure at scale: the tile kernel is FLOP-bound,
    # so padding FLOPs decide and the smallest tile wins (measured on the
    # H100: banded-64k T=128 0.62 ms vs T=256 1.03 ms vs T=512 1.86 ms)
    a = banded_csr(16384, 16384, 192, seed=0)
    b = banded_csr(16384, 16384, 192, seed=1)
    t_big, det = choose_tile_size(a, b, SpadaConfig(engine_dtype="bfloat16"))
    assert t_big == 128, det
    ts = [det[t]["t_est"] for t in (128, 256, 384, 512)]
    assert ts[0] < ts[1] < ts[3], det

    # narrow band (~half a 128 tile): fat tiles quadruple padding bytes
    a2 = banded_csr(16384, 16384, 32, seed=2)
    b2 = banded_csr(16384, 16384, 32, seed=3)
    t_small, det2 = choose_tile_size(a2, b2, SpadaConfig())
    assert t_small == 128, det2


def test_plan_op_dataflow_drives_tm():
    """Schemes 1/2 commit per-anchor heights that pick the op panel height
    (colwise_reg_adjust.rs:47-109 / colwise_irr_adjust.rs:47-110 driving a
    real kernel parameter instead of a model)."""
    from spada_tpu.io.workloads import banded_csr, powerlaw_csr
    from spada_tpu.plan.planner import plan_op_dataflow

    a = banded_csr(512, 512, 32, seed=5, dtype=np.float32)
    b = banded_csr(512, 512, 32, seed=6, dtype=np.float32)
    for scheme in (1, 2):
        tm, det = plan_op_dataflow(a, b, scheme=scheme)
        assert tm in (8, 16, 32, 64, 128)
        assert det["anchors"] > 0 and det["heights"]
        # deterministic
        tm2, _ = plan_op_dataflow(a, b, scheme=scheme)
        assert tm2 == tm

    sc_a = powerlaw_csr(512, 512, 3.0, seed=7, dtype=np.float32)
    sc_b = powerlaw_csr(512, 512, 3.0, seed=8, dtype=np.float32)
    tm, det = plan_op_dataflow(sc_a, sc_b, scheme=1)
    assert tm in (8, 16, 32, 64, 128)


def test_op_dataflow_planned_matches_scipy():
    """spgemm(dataflow='op') with the planner-chosen tm stays scipy-exact."""
    from spada_tpu.io.workloads import random_csr
    from spada_tpu.ops.spgemm import spgemm

    a = random_csr(96, 64, 0.15, seed=11, dtype=np.float32)
    b = random_csr(64, 80, 0.15, seed=12, dtype=np.float32)
    res = spgemm(a, b, SpadaConfig(precision="highest"), dataflow="op")
    ref = np.asarray((a.to_scipy() @ b.to_scipy()).todense())
    np.testing.assert_allclose(res.todense(), ref, rtol=1e-5, atol=1e-5)
