"""BSR construction tests — tile decomposition must be lossless."""

import numpy as np

from spada_tpu.io.workloads import powerlaw_csr, random_csr
from spada_tpu.sparse.bsr import BsrMatrix, tiles_of_csr


def test_bsr_roundtrip_random():
    a = random_csr(100, 300, 0.05, seed=3)
    for tm in (8, 32, 128):
        b = BsrMatrix.from_csr(a, tm, 128)
        np.testing.assert_allclose(b.todense(), a.todense().astype(np.float32), rtol=1e-6)


def test_bsr_roundtrip_cari(cari):
    b = BsrMatrix.from_csr(cari, 64, 128)
    np.testing.assert_allclose(b.todense(), cari.todense().astype(np.float32), rtol=1e-6)


def test_bsr_counts(cari):
    b = BsrMatrix.from_csr(cari, 8, 128)
    assert int(b.nnz_per_tile.sum()) == cari.nnz
    trow, tcol, counts = tiles_of_csr(cari, 8, 128)
    assert counts.sum() == cari.nnz
    assert len(trow) == b.n_tiles
    np.testing.assert_array_equal(tcol, b.tile_col)


def test_bsr_empty():
    from spada_tpu.sparse.csr import CsrMatrix

    a = CsrMatrix((16, 16), np.zeros(17, dtype=np.int64), [], [])
    b = BsrMatrix.from_csr(a, 8, 128)
    assert np.all(b.todense() == 0)


def test_bsr_occupancy_signal():
    dense_ish = random_csr(128, 128, 0.5, seed=4)
    sparse = powerlaw_csr(1024, 1024, 3.0, seed=5)
    b1 = BsrMatrix.from_csr(dense_ish, 128, 128)
    b2 = BsrMatrix.from_csr(sparse, 128, 128)
    assert b1.occupancy() > b2.occupancy()


def test_bsr_value_map_refresh():
    """Value refresh through a prebuilt map == full from_csr rebuild (the
    reference's NN mode: static sparsity structure, per-batch values,
    py2rust.rs:5-60)."""
    from spada_tpu.io.workloads import powerlaw_csr
    from spada_tpu.sparse.bsr import BsrMatrix, BsrValueMap

    m = powerlaw_csr(300, 260, 6.0, seed=9, dtype=np.float32)
    vm = BsrValueMap.from_structure(m, 64, 128)
    b1 = BsrMatrix.from_csr(m, 64, 128)
    np.testing.assert_array_equal(vm.fill(m.data), b1.tiles)

    # refresh with new values: equals a from-scratch build on the new data
    rng = np.random.default_rng(3)
    new_data = rng.standard_normal(m.nnz).astype(np.float32)
    m2 = type(m)(m.shape, m.indptr, m.indices, new_data)
    b2 = b1.refill(vm, new_data)
    ref = BsrMatrix.from_csr(m2, 64, 128)
    np.testing.assert_array_equal(b2.tiles, ref.tiles)
    # structure metadata shared/unchanged
    np.testing.assert_array_equal(b2.tile_col, b1.tile_col)
    np.testing.assert_array_equal(b2.tile_rowptr, b1.tile_rowptr)


def test_bsr_value_map_empty():
    from spada_tpu.sparse.csr import CsrMatrix
    from spada_tpu.sparse.bsr import BsrMatrix, BsrValueMap

    z = CsrMatrix((10, 10), np.zeros(11, np.int64), [], [])
    vm = BsrValueMap.from_structure(z, 8, 8)
    t = vm.fill(np.zeros(0, np.float32))
    assert t.shape == (1, 8, 8) and not t.any()
    b = BsrMatrix.from_csr(z, 8, 8)
    np.testing.assert_array_equal(b.tiles, t)


# ---- timing utility (CPU smoke of the harness's mechanics; times taken
# here are not device numbers) ----

def test_device_time_positive():
    import jax.numpy as jnp

    from spada_tpu.utils.timing import device_time

    def fn(x):
        return x * 2.0

    x = jnp.ones((256, 256), jnp.float32)
    el = device_time(fn, (x,), k=4, trials=2)
    assert el > 0


def test_device_time_mixed_dtype_args():
    """The harness perturbs float args in place on carried buffers and
    passes integer args (packed plans, index maps) through untouched —
    mixed signatures like the tile engines' must time cleanly, and a
    pytree output (the element executors' per-class tuple) must too."""
    import jax.numpy as jnp

    from spada_tpu.utils.timing import device_time_stats

    def fn(idx, xf, yb):
        # gather by int plan + bf16 operand: both dtypes in one signature
        return (jnp.take(xf, idx, axis=0) * 2.0,
                yb.astype(jnp.float32) + 1.0)

    idx = jnp.arange(64, dtype=jnp.int32)
    xf = jnp.ones((64, 128), jnp.float32)
    yb = jnp.ones((8, 128), jnp.bfloat16)
    el, samples = device_time_stats(fn, (idx, xf, yb), k=4, trials=2)
    assert el > 0 and len(samples) == 2


def test_device_time_empty_float_arg():
    import jax.numpy as jnp

    from spada_tpu.utils.timing import device_time

    z = jnp.zeros((0, 128), jnp.float32)
    x = jnp.ones((32, 128), jnp.float32)
    el = device_time(lambda z_, x_: (jnp.sum(z_), x_ * 3.0), (z, x),
                     k=4, trials=2)
    assert el > 0
