"""Plan-time structure-aware densification (plan/densify.py).

The planner must reorder/anchor the layout
where structure pays for it (misaligned bands, scale-free graphs) and keep
natural order where it does not (aligned bands, community-local matrices) —
and the transformed product must stay scipy-exact after row restoration.
"""

import numpy as np
import pytest

from spada_tpu.config import SpadaConfig
from spada_tpu.io.workloads import (GemmWorkload, banded_csr,
                                    banded_offset_csr, localized_powerlaw_csr,
                                    rmat_csr)
from spada_tpu.plan.densify import (DensifyPlan, _tile_stats, apply_densify,
                                    choose_densify, degree_perm, invert_rows)


def _cfg():
    return SpadaConfig(tile_k=128, tile_n=128, default_tm=128)


def test_anchor_recovers_misaligned_band():
    a = banded_offset_csr(4096, 4096, 96, 64, seed=0, dtype=np.float32)
    b = banded_offset_csr(4096, 4096, 96, 64, seed=1, dtype=np.float32)
    base = _tile_stats(a, b, 128, 128, 128)
    plan = choose_densify(a, b, 128, 128, 128, _cfg())
    assert plan.k_anchor != 0, plan.candidate
    assert plan.k_perm is None and plan.row_perm is None
    assert plan.modeled["w"] < 0.75 * base[2]  # >=1.33x fewer work items


def test_aligned_band_keeps_identity():
    a = banded_csr(4096, 4096, 128, seed=0, dtype=np.float32)
    b = banded_csr(4096, 4096, 128, seed=1, dtype=np.float32)
    plan = choose_densify(a, b, 128, 128, 128, _cfg())
    assert plan.is_identity, plan.candidate


def test_rmat_picks_degree_clustering():
    a = rmat_csr(4096, 16.0, seed=1, dtype=np.float32)
    b = rmat_csr(4096, 16.0, seed=2, dtype=np.float32)
    base = _tile_stats(a, b, 128, 128, 128)
    plan = choose_densify(a, b, 128, 128, 128, _cfg())
    assert plan.k_perm is not None, plan.candidate
    assert plan.modeled["w"] < 0.8 * base[2]


def test_local_powerlaw_keeps_natural_order():
    a = localized_powerlaw_csr(4096, 4096, 16.0, seed=1, dtype=np.float32)
    b = localized_powerlaw_csr(4096, 4096, 16.0, seed=2, dtype=np.float32)
    plan = choose_densify(a, b, 128, 128, 128, _cfg())
    # community structure is already clustered: identity within model noise
    assert plan.is_identity, (plan.candidate, plan.modeled)


def test_apply_densify_product_exact_anchor():
    a = banded_offset_csr(512, 512, 48, 32, seed=0, dtype=np.float64)
    b = banded_offset_csr(512, 512, 48, 32, seed=1, dtype=np.float64)
    plan = DensifyPlan(k_anchor=32)
    a2, b2 = apply_densify(a, b, plan)
    assert a2.shape[1] == b2.shape[0] == 512 + 32
    ref = (a.to_scipy() @ b.to_scipy()).todense()
    got = (a2.to_scipy() @ b2.to_scipy()).todense()
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-12)


def test_apply_densify_product_exact_perms():
    rng = np.random.default_rng(3)
    a = rmat_csr(512, 8.0, seed=3, dtype=np.float64)
    b = rmat_csr(512, 8.0, seed=4, dtype=np.float64)
    kp = degree_perm(rng.standard_normal(512))
    rp = degree_perm(rng.standard_normal(512))
    plan = DensifyPlan(k_perm=kp, row_perm=rp, k_anchor=16)
    a2, b2 = apply_densify(a, b, plan)
    from spada_tpu.sparse.csr import CsrMatrix

    got = CsrMatrix.from_scipy((a2.to_scipy() @ b2.to_scipy()).tocsr())
    got = invert_rows(plan, got)
    ref = (a.to_scipy() @ b.to_scipy()).todense()
    np.testing.assert_allclose(got.todense(), np.asarray(ref), rtol=1e-12)


def test_workload_densified_spgemm_matches_scipy():
    from spada_tpu.ops.spgemm import spgemm

    a = rmat_csr(1024, 8.0, seed=5, dtype=np.float32)
    w = GemmWorkload.from_matrix("rmat1k", a)
    cfg = SpadaConfig(tile_k=128, tile_n=128, default_tm=128,
                      element_dispatch="never")
    w2, dplan = w.preprocess_densified(cfg)
    res = spgemm(w2.a, w2.b, cfg, dataflow="spada")
    c = w2.restore_row_order(res.to_csr())
    ref = np.asarray(w.reference_product().todense())
    np.testing.assert_allclose(c.todense(), ref, rtol=1e-4, atol=1e-3)


def test_densified_workload_composes_with_sorted_preprocess():
    a = rmat_csr(512, 8.0, seed=6, dtype=np.float32)
    w = GemmWorkload.from_matrix("rmat512", a).preprocess_sorted()
    w2, dplan = w.preprocess_densified(_cfg())
    got = w2.restore_row_order(
        __import__("spada_tpu.sparse.csr", fromlist=["CsrMatrix"]).CsrMatrix
        .from_scipy((w2.a.to_scipy() @ w2.b.to_scipy()).tocsr()))
    ref = np.asarray((a.to_scipy() @ a.to_scipy()).todense())
    np.testing.assert_allclose(got.todense(), ref, rtol=1e-5, atol=1e-5)


def test_spgemm_auto_densify_is_c_invariant():
    """spgemm() applies the C-invariant densify subset automatically
    (config.densify='auto', the default): the result must equal scipy in
    the ORIGINAL row/column order with no caller-side inverse."""
    from spada_tpu.ops.spgemm import spgemm

    a = rmat_csr(1024, 8.0, seed=7, dtype=np.float32)
    b = rmat_csr(1024, 8.0, seed=8, dtype=np.float32)
    cfg = SpadaConfig(tile_k=128, tile_n=128, default_tm=128,
                      element_dispatch="never")
    res = spgemm(a, b, cfg, dataflow="spada")
    ref = np.asarray((a.to_scipy() @ b.to_scipy()).todense())
    np.testing.assert_allclose(res.todense(), ref, rtol=1e-4, atol=1e-3)

    cfg_off = SpadaConfig(tile_k=128, tile_n=128, default_tm=128,
                          element_dispatch="never", densify="off")
    res_off = spgemm(a, b, cfg_off, dataflow="spada")
    np.testing.assert_allclose(res_off.todense(), ref, rtol=1e-4, atol=1e-3)
    # the densified run must not have issued more work
    assert res.n_work_items <= res_off.n_work_items
