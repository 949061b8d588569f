"""Randomized dispatch fuzz: odd shapes / densities / structures through
the full ``spgemm`` auto-dispatch (and the slabbed CSR path) vs the scipy
oracle — the property form of SURVEY.md §4's numerical-oracle strategy.

Each case draws shape, density, and generator from a seeded RNG so
failures reproduce by seed; sizes stay small (<=320) to keep the CPU
suite fast while still crossing tile boundaries, empty rows/cols, and the
element-vs-tile dispatch threshold.
"""

import numpy as np
import pytest

from spada_tpu.config import SpadaConfig
from spada_tpu.io.workloads import (banded_csr, localized_powerlaw_csr,
                                    powerlaw_csr, random_csr)
from spada_tpu.ops.spgemm import dispatch_dataflow, spgemm, spgemm_csr
from spada_tpu.sparse.csr import CsrMatrix


def _random_case(seed: int):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(1, 320))
    k = int(rng.integers(1, 320))
    n = int(rng.integers(1, 320))
    kind = rng.choice(["random", "powerlaw", "locpl", "banded", "empty_rows"])
    if kind == "random":
        dens = float(10 ** rng.uniform(-3, -0.5))
        a = random_csr(m, k, dens, seed=seed * 2 + 1)
        b = random_csr(k, n, dens, seed=seed * 2 + 2)
    elif kind == "powerlaw":
        a = powerlaw_csr(m, k, float(rng.uniform(1, 8)), seed=seed * 2 + 1)
        b = powerlaw_csr(k, n, float(rng.uniform(1, 8)), seed=seed * 2 + 2)
    elif kind == "locpl":
        a = localized_powerlaw_csr(m, k, float(rng.uniform(1, 8)),
                                   seed=seed * 2 + 1)
        b = localized_powerlaw_csr(k, n, float(rng.uniform(1, 8)),
                                   seed=seed * 2 + 2)
    elif kind == "banded":
        bw = int(rng.integers(1, 9))
        a = banded_csr(m, k, bw, seed=seed * 2 + 1)
        b = banded_csr(k, n, bw, seed=seed * 2 + 2)
    else:
        # rows of A and columns of B randomly emptied (ragged structure)
        a = random_csr(m, k, 0.1, seed=seed * 2 + 1).to_scipy().tolil()
        kill = np.random.default_rng(seed).integers(0, 2, m).astype(bool)
        a[np.nonzero(kill)[0], :] = 0
        a = CsrMatrix.from_scipy(a.tocsr())
        b = random_csr(k, n, 0.1, seed=seed * 2 + 2)
    return kind, a, b


@pytest.mark.parametrize("seed", range(12))
def test_auto_dispatch_matches_scipy(seed):
    kind, a, b = _random_case(seed)
    cfg = SpadaConfig()
    res = spgemm(a, b, cfg, dataflow="spada")
    ref = (a.to_scipy() @ b.to_scipy()).toarray().astype(np.float32)
    choice, _ = dispatch_dataflow(a, b, cfg)
    np.testing.assert_allclose(
        res.todense(), ref, rtol=1e-4, atol=1e-4,
        err_msg=f"seed={seed} kind={kind} engine={choice} "
                f"shapes {a.shape}x{b.shape}")


@pytest.mark.parametrize("seed", range(8))
def test_element_backends_agree(seed):
    """The native and NumPy symbolic phases build the same plan, and the
    XLA executor gives the same result on both (identical structure,
    values to f32 roundoff)."""
    from spada_tpu.ops.element import build_esc_plan, spgemm_element

    _, a, b = _random_case(seed)
    cap = [8, 32, 512][seed % 3]
    pn = build_esc_plan(a, b, cap=cap, backend="auto")
    pp = build_esc_plan(a, b, cap=cap, backend="python")
    cn = spgemm_element(a, b, cap=cap, plan=pn).to_csr()
    cp = spgemm_element(a, b, cap=cap, plan=pp).to_csr()
    assert np.array_equal(cn.indptr, cp.indptr)
    assert np.array_equal(cn.indices, cp.indices)
    np.testing.assert_allclose(cn.data, cp.data, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [3, 7, 11])
def test_slabbed_csr_matches_scipy(seed):
    _, a, b = _random_case(seed)
    # force multiple output slabs through a tiny dense-C budget
    cfg = SpadaConfig(dense_c_budget=1 << 18)
    got = spgemm_csr(a, b, cfg, dataflow="rowwise")
    ref = (a.to_scipy() @ b.to_scipy()).tocsr()
    gm = got.to_scipy()
    assert abs(gm - ref).max() <= 1e-4 * max(abs(ref).max(), 1.0)


@pytest.mark.parametrize("seed", range(6))
def test_distributed_triton_fuzz(seed):
    """Random shapes/structures through the tile kernel's distributed
    paths (reduce and halo; interpret mode) on the virtual mesh vs scipy."""
    import jax

    from spada_tpu.parallel import partition_spgemm, spgemm_sharded
    from spada_tpu.parallel.halo import partition_halo, spgemm_halo

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    label, a, b = _random_case(seed + 300)
    if a.nnz == 0 or b.nnz == 0:
        pytest.skip("empty draw")
    ref = np.asarray((a.to_scipy() @ b.to_scipy()).todense(), np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    tm = int(np.random.default_rng(seed).choice([16, 32, 64]))

    prob = partition_spgemm(a, b, 2, 2, tm=tm)
    res = spgemm_sharded(prob, engine="triton", interpret=True)
    err = np.abs(res.todense() - ref).max() / scale
    assert err < 2e-2, (label, "reduce", err)   # bf16 tiles

    hprob = partition_halo(a, b, 4, tm=tm)
    hres = spgemm_halo(hprob, engine="triton", interpret=True)
    err = np.abs(hres.todense() - ref).max() / scale
    assert err < 2e-2, (label, "halo", err)
