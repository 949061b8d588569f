"""Ingestion tests: the mtx parser and workload rules against the scipy oracle
(the reference's own ground-truth path, py2rust.rs:62-97)."""

import os

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

from spada_tpu.io.mtx import load_mtx
from spada_tpu.io.workloads import (
    GemmWorkload,
    load_pickled_gemms,
    random_csr,
    sort_by_length,
)
from spada_tpu.sparse.csr import CsrMatrix

# not imported from conftest: a package named ``tests`` elsewhere on the
# path can shadow this directory's
CARI = os.path.join(os.path.dirname(__file__), "..", "matrices", "cari.mtx")


def test_cari_matches_scipy(cari):
    ref = scipy.io.mmread(CARI).tocsr()
    assert cari.shape == ref.shape
    assert cari.nnz == ref.nnz
    got = cari.to_scipy()
    assert (got != ref).nnz == 0


def test_cari_header_stats(cari):
    # matrices/cari.mtx header: 400 x 1200, 152800 nnz
    assert cari.shape == (400, 1200)
    assert cari.nnz == 152800


def test_symmetric_mtx(tmp_path):
    p = tmp_path / "sym.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "3 3 4\n1 1 2.0\n2 1 -3.0\n3 2 4.5\n3 3 1.0\n"
    )
    m = load_mtx(str(p))
    ref = scipy.io.mmread(str(p)).tocsr()
    np.testing.assert_allclose(m.todense(), ref.toarray())


def test_pattern_mtx(tmp_path):
    p = tmp_path / "pat.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate pattern general\n"
        "2 3 3\n1 1\n2 3\n1 2\n"
    )
    m = load_mtx(str(p))
    ref = scipy.io.mmread(str(p)).tocsr()
    np.testing.assert_allclose(m.todense(), ref.toarray())


def test_workload_b_rule_square():
    a = random_csr(16, 16, 0.2, seed=1)
    w = GemmWorkload.from_matrix("sq", a)
    assert (w.b.to_scipy() != a.to_scipy()).nnz == 0  # B = A


def test_workload_b_rule_rect(cari_workload):
    # non-square => B = A^T (gemm.rs:41-53)
    a = cari_workload.a.to_scipy()
    b = cari_workload.b.to_scipy()
    assert (b != a.T.tocsr()).nnz == 0


def test_sort_by_length_and_restore():
    a = random_csr(50, 40, 0.1, seed=2)
    w = GemmWorkload.from_matrix("r", a).preprocess_sorted()
    lens = w.a.row_lens()
    assert np.all(np.diff(lens) >= 0)  # ascending nnz
    # product with reordered A then restored == oracle on original order
    c_perm = (w.a.to_scipy() @ w.b.to_scipy()).tocsr()
    c = w.restore_row_order(CsrMatrix.from_scipy(c_perm))
    ref = (a.to_scipy() @ w.b.to_scipy()).tocsr()
    np.testing.assert_allclose(c.todense(), ref.toarray(), rtol=1e-12)


def test_pickled_gemms(tmp_path):
    import pickle

    a = sp.random(12, 8, 0.3, format="csr", random_state=0)
    b = sp.random(8, 10, 0.4, format="coo", random_state=1)
    p = tmp_path / "nn.pkl"
    with open(p, "wb") as f:
        pickle.dump({"layer0": (a, b)}, f)
    w = load_pickled_gemms(str(p), "layer0")
    np.testing.assert_allclose(w.a.todense(), a.toarray())
    np.testing.assert_allclose(w.b.todense(), b.toarray())
    with pytest.raises(KeyError):
        load_pickled_gemms(str(p), "nope")


def test_csr_roundtrip_coo_duplicates():
    # duplicate coordinates must sum (COO semantics)
    m = CsrMatrix.from_coo((2, 2), [0, 0, 1], [1, 1, 0], [1.0, 2.0, 5.0])
    np.testing.assert_allclose(m.todense(), [[0, 3.0], [5.0, 0]])


def test_transpose(cari):
    t = cari.transpose()
    ref = cari.to_scipy().T.tocsr()
    assert (t.to_scipy() != ref).nnz == 0


# ---- NN workload generation ----

def test_nn_workload_pickle_roundtrip(tmp_path):
    import numpy as np

    from spada_tpu.io.workloads import load_pickled_gemms
    from spada_tpu.models.nn_workloads import write_nn_pickle
    from spada_tpu.ops.spgemm import spgemm

    pkl = tmp_path / "nn_gemm.pkl"
    layers = {"tiny_fc": ((256, 192), 48)}
    write_nn_pickle(str(pkl), density=0.15, layers=layers, seed=3)
    w = load_pickled_gemms(str(pkl), "tiny_fc")
    assert w.a.shape == (256, 192) and w.b.shape == (192, 48)
    res = spgemm(w.a, w.b, dataflow="rowwise")
    ref = np.asarray(w.reference_product().todense())
    np.testing.assert_allclose(res.todense(), ref, rtol=1e-4, atol=1e-4)


def test_nn_structured_block_pruning():
    import numpy as np

    from spada_tpu.models.nn_workloads import pruned_weight
    from spada_tpu.sparse.bsr import BsrMatrix
    from spada_tpu.sparse.csr import CsrMatrix

    w = pruned_weight((256, 256), density=0.25, seed=1, structured_block=64)
    csr = CsrMatrix.from_dense(w)
    bsr = BsrMatrix.from_csr(csr, 64, 64)
    # block pruning -> tile occupancy equals scalar density of kept blocks
    assert bsr.n_tiles <= 5  # 25% of 16 blocks, rounded up
    assert bsr.occupancy() > 0.9


def test_localized_powerlaw_tile_density():
    import numpy as np

    from spada_tpu.io.workloads import localized_powerlaw_csr, powerlaw_csr
    from spada_tpu.sparse.bsr import BsrMatrix
    from spada_tpu.sparse.csr import CsrMatrix

    loc = localized_powerlaw_csr(16384, 16384, 8.0, window_frac=0.005,
                                 hub_frac=0.05, seed=1)
    uni = powerlaw_csr(16384, 16384, 8.0, seed=1)
    b_loc = BsrMatrix.from_csr(loc, 128, 128)
    b_uni = BsrMatrix.from_csr(uni, 128, 128)
    # locality -> denser tiles (higher occupancy, fewer tiles)
    assert b_loc.occupancy() > 2 * b_uni.occupancy()
    assert b_loc.n_tiles < b_uni.n_tiles


def test_affinity_reordering_valid_permutation():
    import numpy as np

    from spada_tpu.io.workloads import affinity_based_row_reordering
    from spada_tpu.sparse.csr import CsrMatrix

    # two interleaved column communities: affinity ordering should place
    # same-community rows adjacently more often than the interleaved input
    rows, cols = [], []
    for r in range(40):
        comm = r % 2
        for c in range(10):
            rows.append(r)
            cols.append(comm * 50 + (r // 2 + c) % 50)
    a = CsrMatrix.from_coo((40, 100), rows, cols, np.ones(len(rows)))
    order = affinity_based_row_reordering(a, cache_size=4096,
                                          a_avg_row_len=10, b_avg_row_len=10)
    assert sorted(order.tolist()) == list(range(40))
    same_comm_adjacent = sum(
        1 for i in range(39) if order[i] % 2 == order[i + 1] % 2
    )
    interleaved_adjacent = 0  # strictly alternating input has none
    assert same_comm_adjacent > 20 > interleaved_adjacent


def test_block_sparse_csr_structure():
    import numpy as np

    from spada_tpu.io.workloads import block_sparse_csr

    s = block_sparse_csr(100, 130, 16, 0.3, seed=1)
    s.to_scipy().check_format(full_check=True)  # canonical CSR, no sort
    d = s.todense()
    pr, pc = -(-100 // 16), -(-130 // 16)
    pad = np.zeros((pr * 16, pc * 16))
    pad[:100, :130] = d
    occ = (np.abs(pad.reshape(pr, 16, pc, 16).swapaxes(1, 2)) > 0
           ).reshape(pr, pc, -1)
    nzb, full = occ.any(-1), occ.all(-1)
    interior = np.ones((pr, pc), bool)
    interior[-1, :] = interior[:, -1] = False
    # interior nonzero blocks are fully dense (edge blocks clip)
    assert np.all(full[nzb & interior])
    assert abs(nzb.sum() / (pr * pc) - 0.3) < 0.05
    # deterministic per seed
    s2 = block_sparse_csr(100, 130, 16, 0.3, seed=1)
    assert np.array_equal(s2.indices, s.indices)
    # sampled-fill path still canonical
    f = block_sparse_csr(64, 64, 16, 0.5, fill=0.3, seed=2)
    f.to_scipy().check_format(full_check=True)


def test_relu_activation_csr():
    import numpy as np

    from spada_tpu.io.workloads import relu_activation_csr

    r = relu_activation_csr(200, 300, 0.25, seed=2)
    r.to_scipy().check_format(full_check=True)
    assert abs(r.nnz / (200 * 300) - 0.25) < 0.02  # Bernoulli density
    assert np.all(r.data >= 0) and np.all(r.data <= 1)
    lens = r.row_lens()
    assert lens.min() > 30  # no degenerate empty rows at this density


# ---- real-structure PDE generators ----

def test_stencil_5pt_exact():
    import scipy.sparse as sp

    from spada_tpu.io.workloads import stencil_5pt_csr

    nx, ny = 9, 13
    m = stencil_5pt_csr(nx, ny)
    t = lambda k: sp.diags([-np.ones(k - 1), 2 * np.ones(k),
                            -np.ones(k - 1)], [-1, 0, 1])
    ref = sp.kronsum(t(ny), t(nx))  # kron(I,Ty)+kron(Tx,I)
    assert np.allclose(m.todense(), ref.todense())
    assert m.nnz == 5 * nx * ny - 2 * (nx + ny)


def test_stencil_7pt_exact():
    import scipy.sparse as sp

    from spada_tpu.io.workloads import stencil_7pt_csr

    nx, ny, nz = 4, 5, 6
    m = stencil_7pt_csr(nx, ny, nz)
    t = lambda k: sp.diags([-np.ones(k - 1), 2 * np.ones(k),
                            -np.ones(k - 1)], [-1, 0, 1])
    ref = sp.kronsum(sp.kronsum(t(nz), t(ny)), t(nx))
    assert np.allclose(m.todense(), ref.todense())


def test_fem_q1_graded_spd_and_stencil():
    from spada_tpu.io.workloads import fem_q1_graded_csr

    g = fem_q1_graded_csr(12, 10, grading=1.2, anisotropy=3.0)
    d = g.todense()
    assert np.allclose(d, d.T)
    assert np.linalg.eigvalsh(d).min() > 0          # SPD stiffness
    # uniform grid: interior row sums vanish (constants in the kernel)
    g1 = fem_q1_graded_csr(8, 8, grading=1.0)
    dd = g1.todense()
    inner = [i * 7 + j for i in range(1, 6) for j in range(1, 6)]
    assert np.allclose(dd[inner].sum(axis=1), 0, atol=1e-12)
    # graded grid breaks translation invariance: rows differ
    d2 = fem_q1_graded_csr(8, 8, grading=1.3).todense()
    assert not np.allclose(d2[inner[0]], np.roll(d2[inner[1]], -1))


def test_save_mtx_roundtrip(tmp_path):
    from spada_tpu.io.mtx import load_mtx, save_mtx
    from spada_tpu.io.workloads import stencil_5pt_csr

    m = stencil_5pt_csr(6, 7)
    p = str(tmp_path / "lap.mtx")
    save_mtx(m, p, comment="test matrix")
    m2 = load_mtx(p)
    assert m2.shape == m.shape
    assert np.allclose(m2.todense(), m.todense())


def test_committed_lap5_matrix():
    """matrices/lap5_32.mtx is loadable by name through the SS category."""
    import os

    from spada_tpu.io.workloads import GemmWorkload, stencil_5pt_csr

    root = os.path.join(os.path.dirname(__file__), "..")
    w = GemmWorkload.from_suitesparse(os.path.join(root, "matrices"),
                                      "lap5_32")
    assert w.a.shape == (1024, 1024)
    assert np.allclose(w.a.todense(), stencil_5pt_csr(32, 32).todense())


def test_stencil_spgemm_matches_scipy():
    from spada_tpu.config import SpadaConfig
    from spada_tpu.io.workloads import stencil_5pt_csr
    from spada_tpu.ops.spgemm import spgemm

    a = stencil_5pt_csr(24, 24, dtype=np.float32)
    res = spgemm(a, a, SpadaConfig(), dataflow="spada")
    ref = np.asarray((a.to_scipy() @ a.to_scipy()).todense())
    np.testing.assert_allclose(res.todense(), ref, rtol=1e-4, atol=1e-4)
