"""Sharded SpGEMM on the virtual 8-device CPU mesh (SURVEY.md §4)."""

import jax
import numpy as np
import pytest

from spada_tpu.config import SpadaConfig
from spada_tpu.io.workloads import GemmWorkload, powerlaw_csr, random_csr
from spada_tpu.parallel import partition_spgemm, spgemm_sharded


@pytest.fixture
def eight_devices():
    """Skip unless 8 devices exist (decided here, not at import)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _ref(a, b):
    return np.asarray((a.to_scipy() @ b.to_scipy()).todense(), np.float64)


@pytest.mark.parametrize("n_dp,n_tp", [(2, 1), (4, 1), (1, 2), (2, 2), (4, 2)])
def test_sharded_matches_scipy(n_dp, n_tp):
    if len(jax.devices()) < n_dp * n_tp:
        pytest.skip("not enough devices")
    a = random_csr(300, 260, 0.05, seed=1)
    b = random_csr(260, 310, 0.06, seed=2)
    prob = partition_spgemm(a, b, n_dp, n_tp, tm=64)
    res = spgemm_sharded(prob)
    np.testing.assert_allclose(res.todense(), _ref(a, b), rtol=1e-5, atol=1e-5)


def test_sharded_8way_powerlaw(eight_devices):
    a = powerlaw_csr(500, 400, 10.0, seed=3)
    b = random_csr(400, 500, 0.04, seed=4)
    prob = partition_spgemm(a, b, 4, 2, tm=32)
    res = spgemm_sharded(prob)
    np.testing.assert_allclose(res.todense(), _ref(a, b), rtol=1e-5, atol=1e-5)
    # work balance: the dp split targets equal work items
    assert prob.imbalance < 3.0


def test_sharded_equals_single_chip(eight_devices):
    """Same-code single-device vs 8-device equality (SURVEY.md §4)."""
    a = random_csr(256, 256, 0.08, seed=5)
    b = random_csr(256, 256, 0.08, seed=6)
    p1 = partition_spgemm(a, b, 1, 1, tm=64)
    p8 = partition_spgemm(a, b, 4, 2, tm=64)
    r1 = spgemm_sharded(p1)
    r8 = spgemm_sharded(p8)
    np.testing.assert_allclose(r1.todense(), r8.todense(), rtol=1e-6, atol=1e-6)


def test_to_csr_roundtrip():
    a = random_csr(200, 180, 0.05, seed=7)
    b = random_csr(180, 150, 0.05, seed=8)
    prob = partition_spgemm(a, b, 2, 2, tm=32)
    res = spgemm_sharded(prob)
    got = np.asarray(res.to_csr().to_scipy().todense())
    ref = _ref(a, b)
    # to_csr drops explicit zeros; compare dense reconstructions
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_cari_sharded(cari_workload):
    w = cari_workload
    prob = partition_spgemm(w.a, w.b, 4, 2, tm=128)
    res = spgemm_sharded(prob)
    ref = np.asarray(w.reference_product().todense())
    np.testing.assert_allclose(res.todense(), ref, rtol=1e-4, atol=1e-3)


def test_empty_shards_ok():
    """Degenerate: more dp shards than occupied tile rows."""
    a = random_csr(40, 64, 0.02, seed=9)
    b = random_csr(64, 40, 0.05, seed=10)
    prob = partition_spgemm(a, b, 8, 1, tm=8)
    res = spgemm_sharded(prob)
    np.testing.assert_allclose(res.todense(), _ref(a, b), rtol=1e-5, atol=1e-5)


# ---- halo-exchange strategy ----

def test_halo_matches_scipy():
    from spada_tpu.parallel.halo import partition_halo, spgemm_halo

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    a = random_csr(300, 260, 0.05, seed=11)
    b = random_csr(260, 310, 0.06, seed=12)
    prob = partition_halo(a, b, 4, tm=64)
    res = spgemm_halo(prob)
    np.testing.assert_allclose(res.todense(), _ref(a, b), rtol=1e-5, atol=1e-5)


def test_halo_equals_reduce_strategy(eight_devices):
    from spada_tpu.parallel.halo import partition_halo, spgemm_halo

    a = powerlaw_csr(400, 320, 8.0, seed=13)
    b = random_csr(320, 400, 0.05, seed=14)
    h = spgemm_halo(partition_halo(a, b, 8, tm=32))
    r = spgemm_sharded(partition_spgemm(a, b, 4, 2, tm=32))
    np.testing.assert_allclose(h.todense(), r.todense(), rtol=1e-5, atol=1e-5)


def test_halo_counts_traffic():
    from spada_tpu.parallel.halo import partition_halo

    a = random_csr(200, 200, 0.05, seed=15)
    b = random_csr(200, 200, 0.05, seed=16)
    prob = partition_halo(a, b, 4, tm=32)
    # every needed remote tile is sent exactly once; per-offset ppermute
    # capacities keep the shipped (padded) slots close to the true count
    assert prob.halo_tiles_sent > 0
    assert prob.halo_tiles_padded >= prob.halo_tiles_sent
    assert prob.halo_tiles_padded == prob.n_dev * sum(prob.caps)
    # the old global-cap all-to-all shipped D*D*max_pair slots; the
    # per-offset scheme must never be worse
    old_global = prob.n_dev * prob.n_dev * max(prob.caps)
    assert prob.halo_tiles_padded <= old_global


def test_choose_parallel_strategy():
    from spada_tpu.parallel import choose_parallel_strategy
    from spada_tpu.parallel.halo import spgemm_halo
    from spada_tpu.parallel.spgemm import spgemm_sharded

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    # dense-ish C, small B: moving B tiles beats moving C partials
    a = random_csr(256, 128, 0.2, seed=20)
    b = random_csr(128, 256, 0.2, seed=21)
    strat, det = choose_parallel_strategy(a, b, 4, tm=32)
    assert det["halo_bytes"] > 0 and det["reduce_bytes"] > 0
    # execute whichever was chosen and check the product
    if strat == "halo":
        res = spgemm_halo(det["halo_problem"])
    else:
        res = spgemm_sharded(det["reduce_problem"])
    np.testing.assert_allclose(res.todense(), _ref(a, b), rtol=1e-5,
                               atol=1e-5)


def test_reduce_scatter_merge_equals_psum():
    """The tp merge via ring reduce_scatter (default) reassembles to the
    same C as the replicating psum all-reduce."""
    a = random_csr(96, 80, 0.12, seed=51, dtype=np.float32)
    b = random_csr(80, 72, 0.12, seed=52, dtype=np.float32)
    prob = partition_spgemm(a, b, n_dp=2, n_tp=4, tm=16)
    r_rs = spgemm_sharded(prob, merge="reduce_scatter")
    r_ps = spgemm_sharded(prob, merge="psum")
    np.testing.assert_allclose(r_rs.todense(), r_ps.todense(),
                               rtol=1e-6, atol=1e-6)
    ref = np.asarray((a.to_scipy() @ b.to_scipy()).todense())
    np.testing.assert_allclose(r_rs.todense(), ref, rtol=1e-4, atol=1e-4)


# ---- the tile kernel (interpret mode on CPU) inside the distributed
# program: per-shard o-sorted worklists read through run pointers ----

def test_sharded_triton_matches_scipy():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    a = random_csr(300, 260, 0.05, seed=31)
    b = random_csr(260, 310, 0.06, seed=32)
    prob = partition_spgemm(a, b, 4, 2, tm=64)
    res = spgemm_sharded(prob, engine="triton", interpret=True)
    ref = _ref(a, b)
    err = np.abs(res.todense() - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err < 2e-2, err  # bf16 tiles, f32 accumulation


def test_sharded_triton_equals_xla_engine():
    """Both per-shard engines run the same decomposition; f32 tiles make
    them agree tightly (the only difference is accumulation order)."""
    import jax.numpy as jnp

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    a = random_csr(200, 160, 0.08, seed=33)
    b = random_csr(160, 220, 0.08, seed=34)
    prob = partition_spgemm(a, b, 2, 2, tm=32)
    r_k = spgemm_sharded(prob, engine="triton", engine_dtype=jnp.float32,
                         interpret=True)
    r_x = spgemm_sharded(prob, engine="xla")
    np.testing.assert_allclose(r_k.todense(), r_x.todense(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("D", [1, 8])
def test_halo_triton_matches_scipy(D):
    from spada_tpu.parallel.halo import partition_halo, spgemm_halo

    if len(jax.devices()) < D:
        pytest.skip(f"needs {D} devices")
    a = powerlaw_csr(400, 320, 8.0, seed=35)
    b = random_csr(320, 400, 0.05, seed=36)
    ref = _ref(a, b)
    prob = partition_halo(a, b, D, tm=32)
    res = spgemm_halo(prob, engine="triton", interpret=True)
    err = (np.abs(res.todense() - ref).max()
           / max(np.abs(ref).max(), 1e-30))
    assert err < 2e-2, (D, err)


def test_shard_worklists_are_o_sorted():
    """Every padded shard worklist is o-sorted with its pad items in the
    dump tile's run, so the run pointers tile the whole worklist."""
    from spada_tpu.parallel.spgemm import shard_run_pointers

    a = random_csr(120, 100, 0.08, seed=37)
    b = random_csr(100, 140, 0.08, seed=38)
    prob = partition_spgemm(a, b, 2, 2, tm=16)
    assert (np.diff(prob.o_tid, axis=-1) >= 0).all()
    ptr = shard_run_pointers(prob.o_tid, prob.nCmax + 1)
    assert ptr.shape == (2, 2, prob.nCmax + 2)
    W = prob.a_tid.shape[-1]
    assert (ptr[..., 0] == 0).all() and (ptr[..., -1] == W).all()
    assert (np.diff(ptr, axis=-1) >= 0).all()


def test_halo_segments_are_o_sorted():
    from spada_tpu.parallel.halo import partition_halo

    a = powerlaw_csr(200, 160, 6.0, seed=39)
    b = random_csr(160, 200, 0.06, seed=40)
    p = partition_halo(a, b, 4, tm=16)
    for lo, hi in zip(p.seg_ptr[:-1], p.seg_ptr[1:]):
        assert (np.diff(p.o_tid[:, lo:hi], axis=-1) >= 0).all()


def test_sharded_inputs_placed_per_device():
    """Each device holds only its own shard of the stacked inputs (no
    whole-problem copy on the first device)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    a = random_csr(160, 120, 0.08, seed=85)
    b = random_csr(120, 150, 0.08, seed=86)
    prob = partition_spgemm(a, b, 2, 2, tm=32)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    x = jax.device_put(prob.a_tiles, NamedSharding(mesh, P("dp", "tp")))
    shapes = {s.data.shape for s in x.addressable_shards}
    assert shapes == {(1, 1) + prob.a_tiles.shape[2:]}
    res = spgemm_sharded(prob, mesh=mesh)
    np.testing.assert_allclose(res.todense(), _ref(a, b), rtol=1e-4,
                               atol=1e-4)
