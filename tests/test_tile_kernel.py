"""The Triton-route tile kernel and what surrounds it, on the CPU.

The kernel runs in interpret mode against a NumPy loop; its Triton IR is
lowered for CUDA here too (what the GPU's compiler then does shows only on
the card — see the ``chip`` tests).  Also: the run pointer, the engine
chooser, the platform module (peak table, backend checks, compile cache),
the native library's build key, and chip_smoke's helpers.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spada_tpu.ops import engine as eng
from spada_tpu.ops.engine import (run_pointer, run_worklist,
                                  run_worklist_triton, run_worklist_xla,
                                  select_engine)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _loop_ref(a_tiles, b_tiles, a_ids, b_ids, o_ids, n_c):
    af = np.asarray(jnp.asarray(a_tiles).astype(jnp.float32), np.float64)
    bf = np.asarray(jnp.asarray(b_tiles).astype(jnp.float32), np.float64)
    c = np.zeros((n_c, af.shape[1], bf.shape[2]))
    for ai, bi, oi in zip(a_ids, b_ids, o_ids):
        c[oi] += af[ai] @ bf[bi]
    return c


def _case(tm, tk, tn, dtype, seed=0):
    """6 C tiles; tiles 1 and 4 have empty runs, tile 5 a long one."""
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.standard_normal((5, tm, tk)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((6, tk, tn)), jnp.float32)
    o = np.array([0, 0, 2, 3, 3, 3, 5, 5, 5, 5, 5], np.int32)
    ai = rng.integers(0, 5, len(o)).astype(np.int32)
    bi = rng.integers(0, 6, len(o)).astype(np.int32)
    return a.astype(dtype), b.astype(dtype), ai, bi, o


SHAPES = [(8, 32, 32), (16, 64, 32), (32, 32, 64), (64, 128, 128),
          (48, 40, 24)]
BLOCKS = [{}, dict(bm=16, bn=16, bk=16)]


@pytest.mark.parametrize("blocks", BLOCKS, ids=["default", "small"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_matches_numpy_loop(dtype, shape, blocks):
    """Interpret mode == NumPy loop, over dtype x tile edge x block size,
    with empty runs and padded heights/edges (8 rows, 40/24 edges)."""
    a, b, ai, bi, o = _case(*shape, dtype)
    prec = "highest" if dtype == jnp.float32 else "default"
    c = run_worklist_triton(a, b, ai, bi, o, 6, precision=prec,
                            interpret=True, **blocks)
    assert c.shape == (6,) + (shape[0], shape[2]) and c.dtype == jnp.float32
    ref = _loop_ref(a, b, ai, bi, o, 6)
    np.testing.assert_allclose(np.asarray(c), ref, rtol=1e-5, atol=1e-4)


def test_tile_kernel_empty_runs_emit_zero_tiles():
    """C tiles with no work items come out as exact zeros (the distributed
    per-round launches sum such tiles instead of slicing them off)."""
    a, b, ai, bi, o = _case(16, 16, 16, jnp.float32, seed=1)
    c = np.asarray(run_worklist_triton(a, b, ai, bi, o, 7,
                                       precision="highest", interpret=True))
    assert np.all(c[1] == 0.0) and np.all(c[4] == 0.0) and np.all(c[6] == 0)


def test_kernel_empty_worklist():
    a, b, _, _, _ = _case(16, 32, 16, jnp.float32)
    c = run_worklist_triton(a, b, np.zeros(0, np.int32),
                            np.zeros(0, np.int32), np.zeros(0, np.int32), 3)
    assert c.shape == (3, 16, 16) and not np.asarray(c).any()


@pytest.mark.parametrize("edge,pref,want", [
    (384, 128, 128), (384, 64, 64), (96, 128, 32), (8, 64, 16),
    (16, 128, 16), (40, 64, 16)])
def test_block_choice(edge, pref, want):
    """Largest power of two <= pref dividing the edge, floored at 16."""
    assert eng._block(max(edge, eng._MIN_DOT), pref) == want


def test_pad_to_is_exact():
    x = jnp.ones((2, 8, 40))
    y = eng._pad_to(eng._pad_to(x, 1, 16), 2, 16)
    assert y.shape == (2, 16, 48)
    assert float(y.sum()) == float(x.sum())
    assert eng._pad_to(x, 1, 8) is x


def test_run_pointer_bounds_each_run():
    o = np.array([0, 0, 2, 2, 2, 4], np.int32)
    ptr = run_pointer(o, 6)
    np.testing.assert_array_equal(ptr, [0, 2, 2, 5, 5, 6, 6])
    assert ptr.dtype == np.int32


def test_run_pointer_rejects_unsorted():
    with pytest.raises(ValueError, match="o-sorted"):
        run_pointer(np.array([0, 2, 1], np.int32), 3)


def test_triton_engine_rejects_k_major():
    from spada_tpu.ops.worklist import build_worklist
    from spada_tpu.sparse.bsr import BsrMatrix
    from spada_tpu.io.workloads import random_csr

    a = random_csr(64, 64, 0.2, seed=3, dtype=np.float32)
    ab = BsrMatrix.from_csr(a, 32, 32)
    wl = build_worklist(ab, ab, order="k")
    with pytest.raises(ValueError, match="row-ordered"):
        run_worklist(wl, ab.tiles, ab.tiles, engine="triton",
                     interpret=True)
    with pytest.raises(ValueError, match="unknown engine"):
        run_worklist(wl, ab.tiles, ab.tiles, engine="cached")


@pytest.mark.parametrize("order,precision,gpu,want", [
    ("row", "default", True, "triton"),
    ("row", "highest", True, "xla"),
    ("k", "default", True, "xla"),
    ("row", "default", False, "xla"),
])
def test_engine_chooser(monkeypatch, order, precision, gpu, want):
    import spada_tpu.platform as platform

    monkeypatch.setattr(platform, "on_gpu", lambda: gpu)
    assert select_engine(order, precision) == want


def test_auto_engine_on_gpu_runs_kernel(monkeypatch):
    """run_worklist(engine=None) on a GPU takes the kernel path."""
    import spada_tpu.platform as platform

    calls = []
    monkeypatch.setattr(platform, "on_gpu", lambda: True)
    monkeypatch.setattr(eng, "run_worklist_triton",
                        lambda *a, **k: calls.append(k) or "kernel")

    class WL:
        order = "row"
        a_tid = b_tid = o_tid = np.zeros(1, np.int32)
        n_c_tiles = 1

    assert run_worklist(WL, None, None, precision="default") == "kernel"
    assert calls and calls[0]["precision"] == "default"


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("tm", [8, 128, 384])
def test_kernel_lowers_for_cuda(dtype, tm):
    """The kernel's Triton IR builds for CUDA on the CPU (the lowering, not
    the GPU compiler: that shows only on the card)."""
    T = 384 if tm == 384 else 128
    at = jax.ShapeDtypeStruct((4, tm, T), dtype)
    bt = jax.ShapeDtypeStruct((4, T, T), dtype)
    ids = jax.ShapeDtypeStruct((9,), jnp.int32)
    ptr = jax.ShapeDtypeStruct((4,), jnp.int32)
    low = jax.jit(lambda p, a, b, x, y: eng._run_triton(
        p, a, b, x, y, n_c_tiles=3)).trace(ptr, ids, ids, at, bt).lower(
        lowering_platforms=("cuda",))
    assert "xla.gpu.triton" in low.as_text()


def test_sharded_kernel_lowers_for_cuda():
    """The per-shard kernel inside shard_map lowers for CUDA as well."""
    from jax.sharding import Mesh

    from spada_tpu.parallel.spgemm import make_sharded_triton_fn

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    fn = make_sharded_triton_fn(mesh, n_c_tiles=5)
    s = lambda shp, dt: jax.ShapeDtypeStruct((2, 2) + shp, dt)  # noqa: E731
    low = fn.trace(s((7,), jnp.int32), s((9,), jnp.int32),
                   s((9,), jnp.int32), s((4, 128, 128), jnp.bfloat16),
                   s((4, 128, 128), jnp.bfloat16)).lower(
        lowering_platforms=("cuda",))
    assert "xla.gpu.triton" in low.as_text()


# ---- platform module ----

def test_peak_table_lookup():
    from spada_tpu.platform import H100_SXM, MODEL_TARGET, peaks_for

    p = peaks_for(H100_SXM)
    assert p is MODEL_TARGET
    assert p.bf16_flops == 989e12 and p.hbm_bytes_per_s == 3.35e12
    assert p.source


def test_peak_table_unknown_kind_raises():
    from spada_tpu.platform import peaks_for

    with pytest.raises(ValueError, match="no published peaks"):
        peaks_for("cpu")


@pytest.mark.parametrize("itemsize,precision,want", [
    (2, "default", 989e12), (2, "highest", 989e12),
    (4, "default", 495e12), (4, "highest", 67e12)])
def test_peak_flops_by_dtype(itemsize, precision, want):
    from spada_tpu.platform import MODEL_TARGET

    assert MODEL_TARGET.flops(itemsize, precision) == want


def test_device_peaks_raise_on_cpu():
    from spada_tpu.platform import device_peaks

    with pytest.raises(ValueError):
        device_peaks()


def test_require_gpu_raises_on_cpu():
    from spada_tpu.platform import require_gpu

    with pytest.raises(RuntimeError, match="cpu"):
        require_gpu("x")


def test_measure_device_perf_raises_off_gpu(cari_workload):
    from spada_tpu.ops.spgemm import measure_device_perf

    w = cari_workload
    with pytest.raises(RuntimeError, match="GPU"):
        measure_device_perf(w.a, w.b)


def test_kernel_decision_tool_raises_off_gpu(monkeypatch):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import kernel_decision

    monkeypatch.setattr(sys, "argv", ["kernel_decision.py", "--check"])
    with pytest.raises(RuntimeError, match="GPU"):
        kernel_decision.main()


def test_compile_cache_follows_env(monkeypatch):
    from spada_tpu.platform import setup_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert setup_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    from spada_tpu.platform import default_cache_dir, setup_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = setup_compile_cache()
        assert path == default_cache_dir() == os.path.join(ROOT,
                                                           ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# ---- native library: built only from committed source ----

def test_native_build_keyed_on_source_hash(tmp_path, monkeypatch):
    import hashlib

    from spada_tpu import native

    so = native._so_path()
    with open(native._SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    assert so.endswith(f"libspada_native-{digest}.so")
    src = tmp_path / "x.cpp"
    src.write_text("// other source\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    assert native._so_path() != so


def test_native_failure_reported_on_stderr(tmp_path, monkeypatch, capsys):
    from spada_tpu import native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", None)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_build", lambda so: "g++ not found")
    assert native.load() is None
    assert "g++ not found" in capsys.readouterr().err
    assert native.load() is None                     # reported once
    assert capsys.readouterr().err == ""


def test_native_rebuilds_unloadable_library(tmp_path, monkeypatch):
    from spada_tpu import native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", None)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    so = native._so_path()
    with open(so, "wb") as f:
        f.write(b"not a shared object")
    built = []
    real_build = native._build
    monkeypatch.setattr(native, "_build",
                        lambda p: built.append(p) or real_build(p))
    lib = native.load()
    assert built == [so]
    assert lib is not None and hasattr(lib, "esc_plan")


# ---- chip_smoke helpers ----

def _smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def test_chip_smoke_result_line():
    import json

    cs = _smoke()
    line = cs.result_line({"platform": "gpu", "kind": "K", "count": 1,
                           "extra": 1})
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "K", "count": 1}}


def test_chip_smoke_check_raises_above_tolerance(capsys):
    cs = _smoke()
    cs.check("p", 1e-3, 2e-2, 0.1, "triton")
    assert "relerr 1.000e-03 (tolerance 0.02)" in capsys.readouterr().out
    with pytest.raises(AssertionError):
        cs.check("p", 3e-2, 2e-2, 0.1, "triton")


def test_chip_smoke_sparse_relerr():
    import scipy.sparse as sp

    cs = _smoke()
    ref = sp.csr_matrix(np.array([[0.0, 2.0], [4.0, 0.0]]))
    got = sp.csr_matrix(np.array([[0.0, 2.0], [4.1, 0.0]]))
    assert abs(cs.sparse_relerr(got, ref) - 0.025) < 1e-12


def test_chip_smoke_fails_without_gpu(capsys):
    cs = _smoke()
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "needs a GPU" in out.err


# ---- on the card (skip here; pytest -m chip on the GPU) ----

@pytest.mark.chip
def test_kernel_compiled_matches_xla_on_gpu(gpu):
    from spada_tpu.io.workloads import block_sparse_csr
    from spada_tpu.ops.worklist import build_worklist
    from spada_tpu.sparse.bsr import BsrMatrix

    a = block_sparse_csr(2048, 2048, 256, 0.3, seed=9)
    ab = BsrMatrix.from_csr(a, 128, 128, dtype=jnp.bfloat16)
    wl = build_worklist(ab, ab, order="row")
    c = run_worklist_triton(ab.tiles, ab.tiles, wl.a_tid, wl.b_tid,
                            wl.o_tid, wl.n_c_tiles)
    ref = run_worklist_xla(ab.tiles, ab.tiles, wl.a_tid, wl.b_tid,
                           wl.o_tid, wl.n_c_tiles, precision="default")
    err = float(jnp.max(jnp.abs(c - ref)) / jnp.max(jnp.abs(ref)))
    assert err < 1e-4, err


@pytest.mark.chip
def test_kernel_f32_tiles_tf32_tolerance_on_gpu(gpu):
    """f32 tiles at precision='default' run in TF32: within 2e-2 of the
    f32-exact XLA engine."""
    from spada_tpu.io.workloads import block_sparse_csr
    from spada_tpu.ops.worklist import build_worklist
    from spada_tpu.sparse.bsr import BsrMatrix

    a = block_sparse_csr(2048, 2048, 256, 0.3, seed=10)
    ab = BsrMatrix.from_csr(a, 128, 128, dtype=np.float32)
    wl = build_worklist(ab, ab, order="row")
    c = run_worklist_triton(ab.tiles, ab.tiles, wl.a_tid, wl.b_tid,
                            wl.o_tid, wl.n_c_tiles, precision="default")
    ref = run_worklist_xla(ab.tiles, ab.tiles, wl.a_tid, wl.b_tid,
                           wl.o_tid, wl.n_c_tiles, precision="highest")
    err = float(jnp.max(jnp.abs(c - ref)) / jnp.max(jnp.abs(ref)))
    assert err < 2e-2, err


@pytest.mark.chip
def test_auto_engine_is_kernel_on_gpu(gpu):
    assert select_engine("row", "default") == "triton"
