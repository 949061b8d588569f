"""Element-granular (ESC) SpGEMM path: correctness, parity, dispatch.

The element engine realizes the reference's PE multiply-merge datapath
(simulator.rs:117-235) for scattered sparsity where dense tiles are empty;
tests pin it against the scipy oracle, check native/numpy planner parity,
and verify the density-regime dispatch.
"""

import numpy as np
import pytest

from spada_tpu.config import SpadaConfig
from spada_tpu.io.workloads import (banded_csr, localized_powerlaw_csr,
                                    powerlaw_csr, random_csr)
from spada_tpu.ops.element import (build_esc_plan, esc_operands, esc_execute,
                                   expansion_products, spgemm_element)
from spada_tpu.ops.spgemm import dispatch_dataflow, spgemm
from spada_tpu.sparse.csr import CsrMatrix


def _oracle(a, b):
    return np.asarray((a.to_scipy() @ b.to_scipy()).todense())


CASES = [
    ("uniform", random_csr(60, 80, 0.08, seed=1, dtype=np.float32),
     random_csr(80, 50, 0.08, seed=2, dtype=np.float32)),
    ("powerlaw", powerlaw_csr(300, 300, 5.0, seed=3, dtype=np.float32),
     powerlaw_csr(300, 300, 5.0, seed=4, dtype=np.float32)),
    ("loc-powerlaw",
     localized_powerlaw_csr(512, 512, 12.0, seed=5, dtype=np.float32),
     localized_powerlaw_csr(512, 512, 12.0, seed=6, dtype=np.float32)),
    ("dense-ish", random_csr(48, 48, 0.6, seed=7, dtype=np.float32),
     random_csr(48, 48, 0.6, seed=8, dtype=np.float32)),
]


@pytest.mark.parametrize("name,a,b", CASES, ids=[c[0] for c in CASES])
def test_element_matches_scipy(name, a, b):
    res = spgemm_element(a, b)
    np.testing.assert_allclose(
        res.todense(), _oracle(a, b), rtol=1e-4, atol=1e-4
    )


def test_element_structure_matches_scipy():
    """Symbolic phase: C's CSR structure equals the boolean product's."""
    a, b = CASES[1][1], CASES[1][2]
    plan = build_esc_plan(a, b)
    sp = ((a.to_scipy() != 0) @ (b.to_scipy() != 0)).tocsr()
    sp.sort_indices()
    assert np.array_equal(plan.indptr, sp.indptr)
    assert np.array_equal(plan.indices, sp.indices)
    assert plan.n_products == expansion_products(a, b)


def test_chunk_split_oversized_segments():
    """cap smaller than segment lengths forces multi-chunk merges."""
    a = random_csr(30, 20, 0.5, seed=11, dtype=np.float32)
    b = random_csr(20, 25, 0.5, seed=12, dtype=np.float32)
    res = spgemm_element(a, b, cap=4)
    plan = res.plan
    assert len(plan.esc_to_csr) > plan.nnz_c  # split chunks exist
    np.testing.assert_allclose(
        res.todense(), _oracle(a, b), rtol=1e-4, atol=1e-4
    )


def test_native_numpy_plan_parity():
    """The C++ planner and the numpy reference produce identical plans."""
    from spada_tpu import native

    if native.load() is None:
        pytest.skip("no native toolchain")
    for _, a, b in CASES[:3]:
        pn = build_esc_plan(a, b, cap=8, backend="auto")
        pp = build_esc_plan(a, b, cap=8, backend="python")
        assert pn.nnz_c == pp.nnz_c
        assert pn.n_padded == pp.n_padded
        assert np.array_equal(pn.indptr, pp.indptr)
        assert np.array_equal(pn.indices, pp.indices)
        assert np.array_equal(pn.esc_to_csr, pp.esc_to_csr)
        assert len(pn.buckets) == len(pp.buckets)
        for bn, bp in zip(pn.buckets, pp.buckets):
            assert bn.L == bp.L
            assert np.array_equal(bn.a_gidx, bp.a_gidx)
            assert np.array_equal(bn.b_gidx, bp.b_gidx)


def test_value_refresh_reuses_plan():
    """Same structure, new values: one plan, re-gathered operands."""
    a, b = CASES[0][1], CASES[0][2]
    plan = build_esc_plan(a, b)
    a2 = CsrMatrix(a.shape, a.indptr, a.indices,
                   a.data * 2.0 + 1.0, check=False)
    vals = esc_execute(esc_operands(plan, a2, b))
    from spada_tpu.ops.element import EscResult

    got = EscResult(plan, vals).todense()
    np.testing.assert_allclose(got, _oracle(a2, b), rtol=1e-4, atol=1e-4)


def test_empty_cases():
    a = random_csr(10, 10, 0.0, seed=0, dtype=np.float32)
    b = random_csr(10, 10, 0.3, seed=1, dtype=np.float32)
    res = spgemm_element(a, b)
    assert res.plan.nnz_c == 0
    assert res.todense().shape == (10, 10)
    assert not res.todense().any()


def test_dispatch_scattered_vs_clustered():
    """Density dispatch: scattered structure -> element; banded -> tile."""
    cfg = SpadaConfig()
    scat_a = powerlaw_csr(2048, 2048, 4.0, seed=20, dtype=np.float32)
    scat_b = powerlaw_csr(2048, 2048, 4.0, seed=21, dtype=np.float32)
    choice, _ = dispatch_dataflow(scat_a, scat_b, cfg)
    assert choice == "element"
    band_a = banded_csr(2048, 2048, 64, seed=22, dtype=np.float32)
    band_b = banded_csr(2048, 2048, 64, seed=23, dtype=np.float32)
    choice, _ = dispatch_dataflow(band_a, band_b, cfg)
    assert choice == "tile"


def test_spgemm_auto_routes_element():
    """spgemm(dataflow='spada') auto-routes scattered input to the element
    engine and still matches scipy."""
    # routing needs scale: at n=1024 a 512-tile grid is nearly a dense
    # matmul and the dispatch (correctly) picks tiles, so route-check at
    # 8192 and numerics-check at 1024 (dense oracle stays small)
    a8 = powerlaw_csr(8192, 8192, 4.0, seed=32, dtype=np.float32)
    b8 = powerlaw_csr(8192, 8192, 4.0, seed=33, dtype=np.float32)
    res8 = spgemm(a8, b8, SpadaConfig(precision="highest"), dataflow="spada")
    assert res8.engine_used == "element"

    a = powerlaw_csr(1024, 1024, 4.0, seed=30, dtype=np.float32)
    b = powerlaw_csr(1024, 1024, 4.0, seed=31, dtype=np.float32)
    res = spgemm(a, b, SpadaConfig(precision="highest"), dataflow="element")
    assert res.engine_used == "element"
    np.testing.assert_allclose(
        res.todense(), _oracle(a, b), rtol=1e-4, atol=1e-4
    )


def test_dispatch_never_forces_tile():
    a = powerlaw_csr(256, 256, 3.0, seed=40, dtype=np.float32)
    b = powerlaw_csr(256, 256, 3.0, seed=41, dtype=np.float32)
    cfg = SpadaConfig(element_dispatch="never", precision="highest")
    res = spgemm(a, b, cfg, dataflow="spada")
    assert res.engine_used == "tile"
    np.testing.assert_allclose(
        res.todense(), _oracle(a, b), rtol=1e-4, atol=1e-4
    )


def test_row_slab_streaming_matches_scipy():
    """Expansions over max_slab_products stream through row slabs
    (EscSlabbedResult) and concatenate exactly — the element path's
    large-scale boundary made explicit."""
    from spada_tpu.ops.element import EscSlabbedResult, spgemm_element

    a = powerlaw_csr(512, 512, 6.0, seed=50, dtype=np.float32)
    b = powerlaw_csr(512, 512, 6.0, seed=51, dtype=np.float32)
    res = spgemm_element(a, b, max_slab_products=2000)
    assert isinstance(res, EscSlabbedResult)
    assert len(res.parts) > 3
    np.testing.assert_allclose(res.todense(), _oracle(a, b),
                               rtol=1e-4, atol=1e-4)
    # aggregate metadata matches the unslabbed plan
    from spada_tpu.ops.element import build_esc_plan

    whole = build_esc_plan(a, b)
    assert res.n_products == whole.n_products
    assert res.nnz_c == whole.nnz_c


def test_row_slab_single_giant_row_not_infinite():
    """A single row whose expansion exceeds the slab budget gets its own
    slab (no infinite recursion) and still computes exactly."""
    from spada_tpu.ops.element import spgemm_element

    a = powerlaw_csr(8, 256, 64.0, seed=52, dtype=np.float32)
    b = powerlaw_csr(256, 256, 8.0, seed=53, dtype=np.float32)
    res = spgemm_element(a, b, max_slab_products=100)
    np.testing.assert_allclose(res.todense(), _oracle(a, b),
                               rtol=1e-4, atol=1e-4)


def test_esc_plan_range_guard():
    """The numpy planner refuses out-of-range expansions loudly (before any
    allocation) instead of silently building ~20 bytes/product of host
    arrays; an unchecked CSR with a fabricated 2^31-element row makes the
    expansion overflow cheaply."""
    import pytest

    from spada_tpu.ops.element import _build_esc_plan_numpy
    from spada_tpu.sparse.csr import CsrMatrix

    a = CsrMatrix((1, 2), np.array([0, 1]), np.array([0]),
                  np.array([1.0]))
    b = CsrMatrix((2, 4), np.array([0, 2**31, 2**31]),
                  np.array([0]), np.array([1.0]), check=False)
    with pytest.raises(ValueError, match="slab"):
        _build_esc_plan_numpy(a, b, cap=512)


def test_esc_execute_out_dtype_cached_separately():
    """The runner cache keys on out_dtype; narrow output matches f32 within
    bf16 rounding (the knob is available even though the bench streams
    f32)."""
    import jax.numpy as jnp

    from spada_tpu.ops.element import (build_esc_plan, esc_execute,
                                       esc_operands, esc_values_host)

    a = powerlaw_csr(256, 256, 6.0, seed=56, dtype=np.float32)
    b = powerlaw_csr(256, 256, 6.0, seed=57, dtype=np.float32)
    plan = build_esc_plan(a, b)
    ops = esc_operands(plan, a, b)
    v32 = esc_values_host(esc_execute(ops))
    v16 = esc_values_host(esc_execute(ops, out_dtype=jnp.bfloat16))
    assert v32.dtype == np.float32
    assert str(v16.dtype) == "bfloat16"
    denom = max(np.abs(v32).max(), 1e-30)
    assert np.max(np.abs(v16.astype(np.float32) - v32)) / denom < 2e-2


# the four structures, through the XLA executor (esc_execute) and the CSR
# extraction, against scipy
@pytest.mark.parametrize("name,a,b", CASES, ids=[c[0] for c in CASES])
def test_stream_matches_scipy(name, a, b):
    from spada_tpu.ops.element import EscResult

    plan = build_esc_plan(a, b)
    vals = esc_execute(esc_operands(plan, a, b))
    got = EscResult(plan, vals).to_csr()
    np.testing.assert_allclose(got.todense(), _oracle(a, b), rtol=1e-4,
                               atol=1e-4)
