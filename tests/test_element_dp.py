"""Distributed element path: dp row partition, zero communication."""

import jax
import numpy as np

from spada_tpu.io.workloads import localized_powerlaw_csr, rmat_csr
from spada_tpu.parallel.element_dp import (partition_element,
                                           spgemm_element_dp)


def _oracle(a, b):
    return np.asarray((a.to_scipy() @ b.to_scipy()).todense())


def test_element_dp_matches_scipy():
    a = localized_powerlaw_csr(1024, 1024, 8.0, seed=60, dtype=np.float32)
    b = localized_powerlaw_csr(1024, 1024, 8.0, seed=61, dtype=np.float32)
    prob = partition_element(a, b, n_dev=8)
    res = spgemm_element_dp(prob)
    np.testing.assert_allclose(res.todense(), _oracle(a, b),
                               rtol=1e-4, atol=1e-4)


def test_element_dp_balances_by_expansion():
    """Slabs are balanced by E, not rows — the hub-degree skew this engine
    targets makes row-count balance meaningless."""
    a = rmat_csr(2048, 8.0, seed=62, dtype=np.float32)
    b = rmat_csr(2048, 8.0, seed=63, dtype=np.float32)
    prob = partition_element(a, b, n_dev=4)
    e = prob.e_per_shard.astype(np.float64)
    assert e.max() / max(e.mean(), 1.0) < 2.0, e
    res = spgemm_element_dp(prob)
    np.testing.assert_allclose(res.todense(), _oracle(a, b),
                               rtol=1e-4, atol=1e-4)


def test_element_dp_program_has_no_collectives():
    """The dp decomposition is communication-free by construction: the
    jaxpr of the SHIPPED program (build_dp_program, the exact callable
    spgemm_element_dp jits) must contain no collective primitive."""
    from spada_tpu.parallel.element_dp import build_dp_program

    a = localized_powerlaw_csr(512, 512, 6.0, seed=64, dtype=np.float32)
    b = localized_powerlaw_csr(512, 512, 6.0, seed=65, dtype=np.float32)
    prob = partition_element(a, b, n_dev=8)
    fn, flat = build_dp_program(prob)
    jaxpr = str(jax.make_jaxpr(fn)(*flat))
    for coll in ("psum", "all_gather", "all_to_all", "ppermute",
                 "reduce_scatter"):
        assert coll not in jaxpr, coll


def test_element_dp_fewer_rows_than_devices():
    """Degenerate shard counts must not crash: trailing shards go empty."""
    a = localized_powerlaw_csr(4, 64, 3.0, seed=66, dtype=np.float32)
    b = localized_powerlaw_csr(64, 64, 3.0, seed=67, dtype=np.float32)
    prob = partition_element(a, b, n_dev=8)
    assert prob.row_bounds[-1] == 4 and len(prob.row_bounds) == 9
    res = spgemm_element_dp(prob)
    np.testing.assert_allclose(res.todense(), _oracle(a, b),
                               rtol=1e-4, atol=1e-4)


def test_strategy_chooser_routes_scattered_to_element_dp():
    """choose_parallel_strategy picks the zero-collective element dp when
    the density dispatch would run the element engine per chip."""
    from spada_tpu.io.workloads import powerlaw_csr
    from spada_tpu.parallel.partition import choose_parallel_strategy

    a = powerlaw_csr(8192, 8192, 4.0, seed=70, dtype=np.float32)
    b = powerlaw_csr(8192, 8192, 4.0, seed=71, dtype=np.float32)
    strat, det = choose_parallel_strategy(a, b, 8)
    assert strat == "element_dp"
    assert det["comm_bytes"] == 0


def test_element_dp_operands_placed_per_device():
    """build_dp_program places every class stack with its dp sharding, so
    each device holds only its own slab, and the program matches the
    single-device executor."""
    import jax
    import numpy as np

    from spada_tpu.io.workloads import localized_powerlaw_csr
    from spada_tpu.ops.element import spgemm_element
    from spada_tpu.parallel.element_dp import (build_dp_program,
                                               partition_element,
                                               spgemm_element_dp)

    if len(jax.devices()) < 4:
        import pytest

        pytest.skip("needs 4 devices")
    a = localized_powerlaw_csr(256, 256, 4.0, seed=15, dtype=np.float32)
    b = localized_powerlaw_csr(256, 256, 4.0, seed=16, dtype=np.float32)
    prob = partition_element(a, b, 4)
    _, flat = build_dp_program(prob)
    for x in flat:
        assert len(x.addressable_shards) == 4
        assert all(s.data.shape[0] == 1 for s in x.addressable_shards)
    r_dp = spgemm_element_dp(prob)
    r_1 = spgemm_element(a, b)
    np.testing.assert_allclose(r_dp.todense(), r_1.todense(),
                               rtol=1e-6, atol=1e-6)
