"""SpGEMM numerical-oracle tests: every path vs scipy.sparse products
(the reference's implicit ground truth, SURVEY.md §4)."""

import numpy as np
import pytest

from spada_tpu.config import SpadaConfig
from spada_tpu.io.workloads import banded_csr, powerlaw_csr, random_csr
from spada_tpu.ops import spgemm
from spada_tpu.ops.worklist import build_worklist
from spada_tpu.sparse.bsr import BsrMatrix


def _check(a, b, dataflow, tm=None, rtol=1e-4, atol=1e-5, **kw):
    res = spgemm(a, b, dataflow=dataflow, tm=tm, **kw)
    ref = (a.to_scipy() @ b.to_scipy()).toarray().astype(np.float32)
    np.testing.assert_allclose(res.todense(), ref, rtol=rtol, atol=atol)
    return res


@pytest.mark.parametrize("dataflow", ["ip", "op", "rowwise", "spada"])
def test_small_random_all_dataflows(dataflow):
    a = random_csr(100, 80, 0.1, seed=10)
    b = random_csr(80, 150, 0.15, seed=11)
    _check(a, b, dataflow)


def test_cari_product(cari_workload):
    w = cari_workload
    res = _check(w.a, w.b, "spada", rtol=1e-3, atol=1e-3)
    # C = A @ A^T on cari is fully dense 400x400
    assert res.to_csr().shape == (400, 400)


@pytest.mark.parametrize("tm", [8, 16, 32, 64, 128])
def test_panel_heights(tm):
    a = powerlaw_csr(300, 200, 5.0, seed=12)
    b = random_csr(200, 300, 0.05, seed=13)
    _check(a, b, "spada", tm=tm)


def test_pallas_interpret_matches_xla():
    # differential: the Pallas tile kernel (interpret on CPU) vs XLA engine
    from spada_tpu.ops.engine import run_worklist

    a = random_csr(64, 64, 0.2, seed=14, dtype=np.float32)
    b = random_csr(64, 64, 0.2, seed=15, dtype=np.float32)
    ab = BsrMatrix.from_csr(a, 32, 32)
    bb = BsrMatrix.from_csr(b, 32, 32)
    wl = build_worklist(ab, bb, order="row")
    rp = run_worklist(wl, ab.tiles, bb.tiles, precision="highest",
                      engine="triton", interpret=True)
    rx = run_worklist(wl, ab.tiles, bb.tiles, precision="highest",
                      engine="xla")
    np.testing.assert_allclose(np.asarray(rp), np.asarray(rx), rtol=1e-5,
                               atol=1e-6)


def test_empty_matrices():
    from spada_tpu.sparse.csr import CsrMatrix

    a = CsrMatrix((10, 20), np.zeros(11, np.int64), [], [])
    b = random_csr(20, 30, 0.2, seed=16)
    res = spgemm(a, b, dataflow="spada")
    assert np.all(res.todense() == 0)


def test_disjoint_structure():
    # A's columns never hit B's nonzero rows -> empty C
    from spada_tpu.sparse.csr import CsrMatrix

    a = CsrMatrix.from_coo((8, 16), [0, 3], [0, 1], [1.0, 2.0])
    b = CsrMatrix.from_coo((16, 8), [10, 12], [0, 1], [3.0, 4.0])
    res = spgemm(a, b, dataflow="spada")
    assert np.all(res.todense() == 0)


def test_banded_chain():
    a = banded_csr(256, 256, 4, seed=17)
    b = banded_csr(256, 256, 4, seed=18)
    _check(a, b, "spada", tm=64)


def test_shape_mismatch_raises():
    a = random_csr(10, 20, 0.2)
    b = random_csr(21, 10, 0.2)
    with pytest.raises(ValueError):
        spgemm(a, b)


def test_worklist_symbolic_matches_scipy():
    # tile-level symbolic structure of C must cover scipy's element structure
    a = random_csr(200, 100, 0.03, seed=19)
    b = random_csr(100, 200, 0.03, seed=20)
    a_bsr = BsrMatrix.from_csr(a, 32, 128)
    b_bsr = BsrMatrix.from_csr(b, 128, 128)
    wl = build_worklist(a_bsr, b_bsr)
    ref = (a.to_scipy() @ b.to_scipy()).tocsr()
    rows, cols = ref.nonzero()
    ref_tiles = set(zip(rows // 32, cols // 128))
    got_tiles = set(zip(wl.c_tile_row.tolist(), wl.c_tile_col.tolist()))
    assert ref_tiles <= got_tiles  # symbolic is an upper bound on true structure


def test_worklist_first_flags():
    a = random_csr(64, 64, 0.2, seed=21)
    b = random_csr(64, 64, 0.2, seed=22)
    wl = build_worklist(BsrMatrix.from_csr(a, 8, 128), BsrMatrix.from_csr(b, 128, 128))
    # o_tid must be non-decreasing with 'first' exactly at run starts
    assert np.all(np.diff(wl.o_tid) >= 0)
    expect_first = np.r_[1, (np.diff(wl.o_tid) != 0).astype(np.int32)]
    np.testing.assert_array_equal(wl.first, expect_first)


def test_useful_flops_count(cari_workload):
    w = cari_workload
    res = spgemm(w.a, w.b, dataflow="spada")
    # cari rows all have 382 nnz; flops = 2 * sum_k nnz_Acol_k * nnz_Brow_k
    a_col = np.bincount(w.a.indices, minlength=w.a.shape[1]).astype(np.int64)
    b_rows = w.b.row_lens()
    assert res.useful_flops == 2 * int((a_col * b_rows).sum())
    assert res.mxu_flops >= res.useful_flops


def test_engine_dispatch():
    from spada_tpu.ops.engine import select_engine

    # CPU in tests: auto never picks the kernel (it would run interpreted)
    assert select_engine("row") == "xla"
    assert select_engine("k") == "xla"
    assert select_engine("row", "highest") == "xla"


def test_spgemm_bf16_engine_dtype(cari_workload):
    from spada_tpu.config import SpadaConfig

    w = cari_workload
    res = spgemm(w.a, w.b, SpadaConfig(engine_dtype="bfloat16",
                                       precision="default"),
                 dataflow="rowwise")
    ref = np.asarray(w.reference_product().todense())
    got = res.todense()
    # bf16 tiles: coarse tolerance, but structure must match exactly
    assert (np.abs(got) > 1e-6).sum() == (np.abs(ref) > 1e-6).sum()
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.5)


def test_spgemm_csr_slabbed():
    """Slabbed CSR path == one-shot path under a tiny C budget."""
    from spada_tpu.config import SpadaConfig
    from spada_tpu.io.workloads import random_csr
    from spada_tpu.ops.spgemm import spgemm_csr

    a = random_csr(300, 256, 0.06, seed=70)
    b = random_csr(256, 300, 0.06, seed=71)
    # budget of ~3 C tiles forces many slabs (tm=32 -> 32*128*4 bytes/tile)
    cfg = SpadaConfig(dense_c_budget=3 * 32 * 128 * 4)
    got = spgemm_csr(a, b, cfg, dataflow="rowwise", tm=32)
    ref = (a.to_scipy() @ b.to_scipy()).tocsr()
    np.testing.assert_allclose(
        np.asarray(got.to_scipy().todense()),
        np.asarray(ref.todense()), rtol=1e-5, atol=1e-5,
    )


def test_spgemm_csr_matches_to_csr():
    from spada_tpu.io.workloads import powerlaw_csr, random_csr
    from spada_tpu.ops.spgemm import spgemm, spgemm_csr

    a = powerlaw_csr(200, 160, 6.0, seed=72)
    b = random_csr(160, 220, 0.08, seed=73)
    one = spgemm(a, b, dataflow="rowwise").to_csr()
    slab = spgemm_csr(a, b, dataflow="rowwise")
    np.testing.assert_allclose(
        np.asarray(one.to_scipy().todense()),
        np.asarray(slab.to_scipy().todense()), rtol=1e-6, atol=1e-6,
    )


def test_oversized_single_tile_run():
    """A single C tile whose run is far longer than any other (every work
    item lands on the same C tile) runs as one program's loop and matches
    XLA."""
    from spada_tpu.ops.engine import run_worklist_triton, run_worklist_xla

    a = random_csr(32, 800, 0.4, seed=82)
    b = random_csr(800, 32, 0.4, seed=83)
    ab = BsrMatrix.from_csr(a, 32, 32, dtype=np.float32)
    bb = BsrMatrix.from_csr(b, 32, 32, dtype=np.float32)
    wl = build_worklist(ab, bb, order="row")
    assert wl.n_c_tiles == 1 and wl.n_items > 12
    ref = np.asarray(run_worklist_xla(
        ab.tiles, bb.tiles, wl.a_tid, wl.b_tid, wl.o_tid,
        n_c_tiles=1, precision="highest",
    ))
    out = run_worklist_triton(
        ab.tiles, bb.tiles, wl.a_tid, wl.b_tid, wl.o_tid,
        n_c_tiles=1, precision="highest", interpret=True,
    )
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5, atol=1e-5)


def test_element_plan_bytes_exact():
    """The dispatch's closed-form byte model equals the built plan's
    operand_bytes exactly (symmetric fidelity with the tile side)."""
    from spada_tpu.config import SpadaConfig
    from spada_tpu.io.workloads import (localized_powerlaw_csr, powerlaw_csr,
                                        random_csr, stencil_5pt_csr)
    from spada_tpu.ops.element import build_esc_plan
    from spada_tpu.ops.spgemm import element_plan_bytes

    cfg = SpadaConfig()
    cases = [
        (random_csr(200, 180, 0.05, seed=61), random_csr(180, 160, 0.06,
                                                         seed=62)),
        (powerlaw_csr(256, 256, 8.0, seed=63), powerlaw_csr(256, 256, 8.0,
                                                            seed=64)),
        (stencil_5pt_csr(20, 20), stencil_5pt_csr(20, 20)),
        (localized_powerlaw_csr(512, 512, 6.0, seed=65),
         localized_powerlaw_csr(512, 512, 6.0, seed=66)),
    ]
    for a, b in cases:
        pb = element_plan_bytes(a, b, cap=cfg.element_cap)
        plan = build_esc_plan(a, b, cap=cfg.element_cap)
        assert pb["bytes"] == plan.operand_bytes(), (pb, plan.n_padded)
        assert pb["n_padded"] == plan.n_padded


def test_dispatch_boundary_both_sides():
    """Pin the tile/element decision on both sides of the density
    crossover, and that the ambiguous band uses the exact byte model."""
    from spada_tpu.config import SpadaConfig
    from spada_tpu.io.workloads import (block_sparse_csr, powerlaw_csr,
                                        stencil_5pt_csr)
    from spada_tpu.ops.spgemm import dispatch_dataflow

    cfg = SpadaConfig()
    # clustered dense blocks: tile engine
    a = block_sparse_csr(2048, 2048, 128, 0.4, seed=70, dtype=np.float32)
    choice_t, det_t = dispatch_dataflow(a, a, cfg)
    assert choice_t == "tile", det_t["element"]
    # scattered power law: element engine
    s = powerlaw_csr(4096, 4096, 4.0, seed=71, dtype=np.float32)
    choice_e, det_e = dispatch_dataflow(s, s, cfg)
    assert choice_e == "element", det_e
    # real PDE stencil: element (tile padding ~40x), via the exact model
    p = stencil_5pt_csr(96, 96, dtype=np.float32)
    choice_p, det_p = dispatch_dataflow(p, p, cfg)
    assert choice_p == "element", det_p
    assert det_p["element"]["bytes_model"] in ("exact", "worst-case")


def test_estimate_element_time_exactness_gating():
    """tile_t outside the [lo, hi] band skips the O(E) pattern product;
    inside the band the exact model engages."""
    from spada_tpu.config import SpadaConfig
    from spada_tpu.io.workloads import random_csr
    from spada_tpu.ops.spgemm import estimate_element_time

    cfg = SpadaConfig()
    a = random_csr(300, 300, 0.05, seed=72)
    b = random_csr(300, 300, 0.05, seed=73)
    det_hi = estimate_element_time(a, b, cfg, tile_t=1e9)
    assert det_hi["bytes_model"] == "worst-case"
    lo_probe = estimate_element_time(a, b, cfg)          # no tile_t: exact
    assert lo_probe["bytes_model"] == "exact"
    mid = (det_hi["t_lo"] + det_hi["t_est"]) / 2         # inside the band
    det_mid = estimate_element_time(a, b, cfg, tile_t=mid)
    assert det_mid["bytes_model"] == "exact"


def test_dispatch_crossover_family_bf16():
    """Pin the bf16-modeled dispatch at the clear extremes of the
    crossover family band-384 n=32768 with per-row fill swept across the
    boundary: fill 96 is tile and fill 8 element, each by a modeled
    margin of 7x or more.  The fills near the boundary are not pinned:
    no winner there has been measured on the card yet."""
    import dataclasses

    from spada_tpu.config import SpadaConfig
    from spada_tpu.ops.spgemm import dispatch_dataflow
    from spada_tpu.sparse.csr import CsrMatrix

    def band_fill(n, bw, fill, seed):
        rng = np.random.default_rng(seed)
        rows = np.repeat(np.arange(n), fill)
        offs = rng.integers(-bw, bw + 1, n * fill)
        cols = np.clip(rows + offs, 0, n - 1)
        return CsrMatrix.from_coo(
            (n, n), rows, cols,
            rng.standard_normal(n * fill).astype(np.float32))

    cfg = dataclasses.replace(SpadaConfig(), engine_dtype="bfloat16")
    expect = {96: "tile", 8: "element"}
    for fill, want in expect.items():
        a = band_fill(32768, 384, fill, seed=fill)
        b = band_fill(32768, 384, fill, seed=fill + 1)
        choice, det = dispatch_dataflow(a, b, cfg)
        assert choice == want, (fill, choice, det["element"])
