"""Headline benchmark: suite of structurally distinct SpGEMM workloads, on
the GPU.

Prints ONE compact JSON line:

  {"metric": "spgemm_pct_binding", "value": <pct>, "unit": "%",
   "vs_baseline": r, "value_naive": <pct>, "device": {...},
   "suite": [{"name", "engine", "ms", "pct_sol", "pct_binding"}, ...]}

and routes the FULL detail to ``BENCH_DETAIL.json`` in ``$SPADA_OUT_DIR``
(default ``out/`` beside this script).  Every
percentage is against the published peaks of the device the run used
(:func:`spada_tpu.platform.device_peaks`).  The script fails, and exits
non-zero, without a GPU or when any entry fails.

``value`` is the suite MEDIAN of per-workload ``pct_binding`` — each
entry's elapsed vs its own BINDING bound, capped at 100.  Per entry:
  tile:    binding bound = max(unique-tile-byte time, tile-FLOP time)
  element: binding bound = plan streamed bytes / peak HBM bandwidth
``value_naive`` is the median against the naive streaming bound (every
work item moves its A and B tile once, C written once).
Suite (engine dispatched per matrix, like the adaptive planner would):

  banded      n=64k, band 384 — PDE/stencil class, tile kernel
  banded_off  same band displaced 192 cols off-diagonal — exercises the
              densify planner's k-grid anchor (without it this workload
              carries 1.77x the work items)
  locpl       localized powerlaw n=64k — SuiteSparse community structure,
              element/ESC engine
  rmat        R-MAT n=32k deg 12 — Graph500 scale-free class, element
              engine
  nn          block-pruned DNN weight (16384^2, 384-blocks, 20%) x
              ReLU-sparse activations (16384x4096, 35%) — the reference's
              NN workload category (py2rust.rs:62-97) in the tile
              engine's long-run regime
  stencil5    exact 2-D 5-point Laplacian, 1536^2 grid (n=2.36M), C=A@A —
              engine picked by dispatch_dataflow
  stencil7    exact 3-D 7-point Laplacian, 128^3 (n=2.1M), C=A@A —
              likewise dispatched

Correctness gates: (a) stock workload cari (C = A·A^T) vs scipy; (b) each
tile entry's engine vs an f32 XLA oracle on the device; (c) each element
entry vs scipy on a row slice.

Timing: :func:`spada_tpu.utils.timing.device_time_stats` (chained on-device
iterations fenced by ``block_until_ready``); per entry the detail reports
the slope-sample spread (min/max) alongside the median.  Each entry is
timed in two passes and scores its better pass; both are reported.
"""

import json
import os
import subprocess
import sys

import numpy as np

# The measurement runs in a child process under a deadline, so this script
# always prints its one JSON line.  The parent stays off JAX: only the
# child opens the card.
_WATCHDOG_S = int(os.environ.get("SPADA_BENCH_TIMEOUT_S", "2700"))


def _watchdog_main() -> int:
    cmd = [sys.executable, os.path.abspath(__file__)]
    env = dict(os.environ, SPADA_BENCH_CHILD="1")
    try:
        # stderr passes through live (stage marks must be visible when a
        # run trips the watchdog); only stdout is captured for the JSON
        proc = subprocess.run(
            cmd, env=env, stdout=subprocess.PIPE, text=True,
            timeout=_WATCHDOG_S,
        )
        out = [l for l in proc.stdout.splitlines() if l.startswith("{")]
        if out:
            print(out[-1])
            return proc.returncode
        reason = f"exit {proc.returncode}"
    except subprocess.TimeoutExpired:
        reason = f"no result within the {_WATCHDOG_S}s watchdog"
    print(json.dumps({
        "metric": "spgemm_pct_binding", "value": 0.0, "unit": "%",
        "vs_baseline": 0.0, "error": reason,
    }))
    return 1


def _cached_workload(key, builder):
    """Disk-cache generated CSR workloads (.bench_cache/<key>.npz).

    Generation is deterministic (fixed seeds) but takes real time across
    the suite.  The key encodes every generator parameter; bump _WLCACHE_V
    on generator semantic changes."""
    import spada_tpu  # noqa: F401  (repo root on path)
    from spada_tpu.sparse.csr import CsrMatrix

    path = os.path.join(_CACHE_ROOT, ".bench_cache",
                        f"{_WLCACHE_V}-{key}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return CsrMatrix(tuple(z["shape"]), z["indptr"], z["indices"],
                         z["data"])
    m = builder()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, shape=np.asarray(m.shape), indptr=m.indptr,
                 indices=m.indices, data=m.data)
    os.replace(tmp, path)
    return m


_WLCACHE_V = "v1"
_CACHE_ROOT = os.path.dirname(os.path.abspath(__file__))
_T0 = None


def _mark(msg):
    """Stage timestamps on stderr (the stdout JSON contract is untouched),
    so per-stage wall time is visible when a run trips the watchdog."""
    global _T0
    import time as _time

    if _T0 is None:
        _T0 = _time.perf_counter()
    print(f"[bench +{_time.perf_counter() - _T0:6.0f}s] {msg}",
          file=sys.stderr, flush=True)


def _spread_ms(samples):
    # negative slope samples happen when noise hits the short run harder
    # than the long one; clamp for display (the median never takes them)
    return [round(max(min(samples), 0.0) * 1e3, 3),
            round(max(samples) * 1e3, 3)]


def _tile_entry(name, a, b, config, T, peaks, densify=False):
    """Tile entry: the library's tile engine (auto: the Triton-route kernel
    on the GPU) on bf16 tiles, gated on the device against an f32 XLA
    oracle, then timed with device_time_stats.

    ``T=None`` lets ``choose_tile_size`` pick the tile edge (the adaptive
    planner's matrix-level decision); the detail records the choice and
    the model column.
    """
    import dataclasses as _dc

    import jax
    import jax.numpy as jnp

    from spada_tpu.io.workloads import GemmWorkload
    from spada_tpu.ops.engine import run_worklist, select_engine
    from spada_tpu.ops.worklist import build_worklist
    from spada_tpu.sparse.bsr import BsrMatrix
    from spada_tpu.utils.timing import device_time_stats

    out = {"name": name, "engine": select_engine("row", "default")}
    _mark(f"{name}: tile entry start")
    if T is None:
        from spada_tpu.plan.planner import choose_tile_size

        T, det = choose_tile_size(
            a, b, _dc.replace(config, engine_dtype="bfloat16",
                              precision="default"))
        out["tile_model_ms"] = {k: round(v["t_est"] * 1e3, 3)
                                for k, v in det.items()}
        out["tile_chosen_by"] = "planner"
    out["tile"] = T
    if densify:
        w = GemmWorkload(name, a, b)
        w2, dplan = w.preprocess_densified(config, tm=T, tk=T, tn=T)
        out["densify"] = dplan.candidate
        out["densify_w_model"] = dplan.modeled.get("all", {})
        a, b = w2.a, w2.b

    a_bsr = BsrMatrix.from_csr(a, T, T, dtype=np.float32)
    b_bsr = BsrMatrix.from_csr(b, T, T, dtype=np.float32)
    wl = build_worklist(a_bsr, b_bsr, order="row")
    W, nC = wl.n_items, wl.n_c_tiles
    at = jnp.asarray(a_bsr.tiles).astype(jnp.bfloat16)
    bt = jnp.asarray(b_bsr.tiles).astype(jnp.bfloat16)

    def engine(at_, bt_):
        return run_worklist(wl, at_, bt_, precision="default")

    # gate: the timed engine vs f32 HIGHEST XLA, on the device
    ai, bi, oi = (jnp.asarray(wl.a_tid), jnp.asarray(wl.b_tid),
                  jnp.asarray(wl.o_tid))

    @jax.jit
    def _relerr(a_eng, bt_):
        c_perf = engine(a_eng, bt_)
        atf = a_eng.astype(jnp.float32)
        btf = bt_.astype(jnp.float32)
        c_ref = jnp.zeros((nC, T, T), jnp.float32)
        step = 2048
        for s in range(-(-W // step)):
            sl = slice(s * step, min((s + 1) * step, W))
            part = jax.lax.dot_general(
                atf[ai[sl]], btf[bi[sl]],
                dimension_numbers=(((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            c_ref = c_ref.at[oi[sl]].add(part)
        return (jnp.max(jnp.abs(c_perf - c_ref)) / jnp.max(jnp.abs(c_ref)))

    _mark(f"{name}: worklist built (W={W}), gating")
    relerr = float(_relerr(at, bt))
    if not relerr < 2e-2:  # bf16 inputs, f32 accumulation
        out["error"] = f"kernel gate failed (relerr={relerr:.3e})"
        return out

    _mark(f"{name}: gate ok, timing")
    elapsed, samples = device_time_stats(engine, (at, bt), k=16, trials=5)
    _mark(f"{name}: timed {elapsed*1e3:.3f} ms")

    isz = 2  # bf16 tiles
    c_bytes = nC * T * T * 4
    bytes_naive = W * (2 * T * T) * isz + c_bytes
    n_a = len(np.unique(wl.a_tid))
    n_b = len(np.unique(wl.b_tid))
    bytes_unique = (n_a + n_b) * T * T * isz + c_bytes
    flops = 2 * W * T * T * T
    t_flops = flops / peaks.bf16_flops
    t_naive = max(bytes_naive / peaks.hbm_bytes_per_s, t_flops)
    t_unique = max(bytes_unique / peaks.hbm_bytes_per_s, t_flops)
    out.update({
        "elapsed_ms": round(elapsed * 1e3, 3),
        "spread_ms": _spread_ms(samples),
        "pct_sol": round(100.0 * t_naive / elapsed, 2),
        "pct_sol_unique": round(100.0 * t_unique / elapsed, 2),
        "sol_ms": round(t_naive * 1e3, 3),
        "sol_unique_ms": round(t_unique * 1e3, 3),
        "flops_floor_ms": round(t_flops * 1e3, 3),
        "hbm_gb_naive": round(bytes_naive / 1e9, 3),
        "hbm_gb_unique": round(bytes_unique / 1e9, 3),
        "work_items": int(W), "c_tiles": int(nC),
        "effective_gflops": round(flops / elapsed / 1e9, 1),
        "relerr": round(relerr, 6),
        # binding bound: the larger of the unique-byte and FLOP bounds,
        # capped at 100 so no entry can score above its physical bound
        "pct_binding": round(min(100.0, 100.0 * t_unique / elapsed), 2),
    })
    out["_retime"] = (engine, (at, bt),
                      {"sol_s": t_naive, "sol_unique_s": t_unique,
                       "flops": flops})
    return out


def _element_entry(name, a, b, config, peaks, gate_rows=2048):
    """Element/ESC entry: gate vs scipy on a row slice, then
    device_time_stats of the XLA executor."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from spada_tpu.ops.element import (_esc_runner, build_esc_plan,
                                       esc_operands, esc_transfer)
    from spada_tpu.utils.timing import device_time_stats

    out = {"name": name, "engine": "element"}
    _mark(f"{name}: element entry start")
    plan = build_esc_plan(a, b)
    _mark(f"{name}: plan built (E={plan.n_products})")
    ops = esc_transfer(esc_operands(plan, a, b))
    run = _esc_runner()
    bytes_sol = plan.operand_bytes()

    # gate on rows [0, gate_rows): gather those chunks on the device and
    # read back only the slice
    vals_dev = run(ops)          # tuple of per-class arrays in esc order
    chunk_row = np.searchsorted(plan.indptr, plan.esc_to_csr,
                                side="right") - 1
    sel = np.nonzero(chunk_row < gate_rows)[0]
    nnz_slice = int(plan.indptr[gate_rows])
    offs = np.cumsum([0] + [int(np.prod(v.shape)) for v in vals_dev])
    subs = []
    for ci, v in enumerate(vals_dev):
        s = sel[(sel >= offs[ci]) & (sel < offs[ci + 1])] - offs[ci]
        if len(s):
            subs.append(np.asarray(
                jnp.take(v.reshape(-1), jnp.asarray(s.astype(np.int32)))))
    sub = (np.concatenate(subs) if subs
           else np.zeros(0, np.float32)).astype(np.float64)
    data = np.zeros(nnz_slice, np.float64)
    np.add.at(data, plan.esc_to_csr[sel], sub)
    got = sp.csr_matrix(
        (data, plan.indices[:nnz_slice], plan.indptr[: gate_rows + 1]),
        shape=(gate_rows, plan.shape[1]))
    ref = (a.to_scipy()[:gate_rows] @ b.to_scipy()).tocsr()
    ref.sort_indices()
    err = abs(got - ref).max() / max(abs(ref).max(), 1e-30)
    if not err < 1e-3:
        out["error"] = f"element gate failed (relerr={err:.3e})"
        return out
    _mark(f"{name}: gate ok, timing")

    flat = [x for pair in ops for x in pair]

    # no operand perturbation here: the timing harness carries every float
    # operand through the loop itself (a caller-side `x + eps` gives the
    # array two consumers and XLA materializes a phantom full-size pass)
    def fn(*xs):
        pairs = tuple((xs[2 * i], xs[2 * i + 1])
                      for i in range(len(xs) // 2))
        return run(pairs)

    elapsed, samples = device_time_stats(fn, tuple(flat), k=16, trials=5)
    _mark(f"{name}: timed {elapsed*1e3:.3f} ms")
    t_sol = bytes_sol / peaks.hbm_bytes_per_s
    out.update({
        "elapsed_ms": round(elapsed * 1e3, 4),
        "spread_ms": _spread_ms(samples),
        "pct_sol": round(100.0 * t_sol / elapsed, 2),
        "stream_gbps": round(bytes_sol / elapsed / 1e9, 1),
        "hbm_gb": round(bytes_sol / 1e9, 3),
        "e_products": plan.n_products, "nnz_c": plan.nnz_c,
        "density_efficiency": round(plan.density_efficiency, 4),
        "relerr": round(float(err), 8),
        # the element path is stream-bound: its naive SoL IS its binding
        # bound (capped at 100)
        "pct_binding": round(min(100.0, 100.0 * t_sol / elapsed), 2),
    })
    out["_retime"] = (fn, tuple(flat),
                      {"sol_s": t_sol, "stream_bytes": bytes_sol})
    return out


def _entry_dispatched(name, a, b, config, peaks):
    """Route through dispatch_dataflow — the adaptive-dataflow decision the
    planner makes for a real matrix — then run the chosen entry type.

    The dispatch models the engine configuration the entry would actually
    run — bf16 tiles (_tile_entry's dtype)."""
    import dataclasses as _dc

    from spada_tpu.ops.spgemm import dispatch_dataflow

    choice, det = dispatch_dataflow(
        a, b, _dc.replace(config, engine_dtype="bfloat16",
                          precision="default"))
    if choice == "element":
        out = _element_entry(name, a, b, config, peaks)
    else:
        out = _tile_entry(name, a, b, config, det["tile_T"], peaks)
    out["dispatch"] = choice
    out["dispatch_t_est_ms"] = {
        "element": round(det["element"]["t_est"] * 1e3, 3),
        "tile": round(min(v["t_est"] for v in det["tile"].values()) * 1e3,
                      3),
    }
    return out


def _calibrate():
    """Same-session reference stream: flat r2w1 f32 multiply, 564 MB
    working set (the element path's dominant mix), reported beside the
    headline; the percentages are NOT rescaled by it."""
    import jax.numpy as jnp

    from spada_tpu.utils.timing import device_time_stats

    n = 47 * 2**20
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    b = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    el, _ = device_time_stats(lambda x, y: (x * y,), (a, b), k=16, trials=3)
    return {"cal_r2w1_ms": round(el * 1e3, 3),
            "cal_r2w1_gbps": round(3 * n * 4 / el / 1e9, 1)}


def _second_pass(entries, config):
    """Re-time every gated entry after its first pass and keep the better
    %-of-SoL (both passes are reported)."""
    from spada_tpu.utils.timing import device_time_stats

    for e in entries:
        rtm = e.pop("_retime", None)
        if rtm is None or "pct_sol" not in e:
            continue
        fn, args, bounds = rtm
        el2, _ = device_time_stats(fn, args, k=16, trials=5)
        pct2 = round(100.0 * bounds["sol_s"] / el2, 2)
        e["passes"] = [e["pct_sol"], pct2]
        if pct2 > e["pct_sol"]:
            e["pct_sol"] = pct2
            e["elapsed_ms"] = round(el2 * 1e3, 4)
            if "sol_unique_s" in bounds:
                e["pct_sol_unique"] = round(
                    100.0 * bounds["sol_unique_s"] / el2, 2)
                e["pct_binding"] = round(
                    min(100.0, 100.0 * bounds["sol_unique_s"] / el2), 2)
                e["effective_gflops"] = round(
                    bounds["flops"] / el2 / 1e9, 1)
            else:
                e["pct_binding"] = round(min(100.0, pct2), 2)
            if "stream_bytes" in bounds:
                e["stream_gbps"] = round(
                    bounds["stream_bytes"] / el2 / 1e9, 1)


def main() -> int:
    from spada_tpu.platform import (device_info, device_peaks,
                                    nvidia_smi_line, require_gpu,
                                    setup_compile_cache)

    require_gpu("bench.py")
    setup_compile_cache()
    peaks = device_peaks()
    smi = nvidia_smi_line()
    _mark(f"card: {smi}")

    from spada_tpu.config import SpadaConfig
    from spada_tpu.io.mtx import load_mtx
    from spada_tpu.io.workloads import (GemmWorkload, banded_csr,
                                        banded_offset_csr, block_sparse_csr,
                                        localized_powerlaw_csr,
                                        relu_activation_csr, rmat_csr,
                                        stencil_5pt_csr, stencil_7pt_csr)
    from spada_tpu.ops.spgemm import measure_device_perf, spgemm

    config = SpadaConfig()
    root = os.path.dirname(os.path.abspath(__file__))
    _mark("imports done")

    # ---- correctness gate: cari (the reference's stock workload) ----
    w = GemmWorkload.from_matrix(
        "cari", load_mtx(os.path.join(root, "matrices/cari.mtx"))
    )
    res = spgemm(w.a, w.b, config, dataflow="spada")
    ref = np.asarray(w.reference_product().todense())
    if not np.allclose(res.todense(), ref, rtol=1e-4, atol=1e-3):
        print(json.dumps({
            "metric": "spgemm_pct_binding", "value": 0.0, "unit": "%",
            "vs_baseline": 0.0, "error": "cari correctness gate failed",
        }))
        return 1

    def guard(fn, *args, **kw):
        """A failing entry reports as an error entry; any error fails the
        run (non-zero exit) after the suite has finished."""
        try:
            return fn(*args, **kw)
        except Exception as e:
            return {"name": args[0] if args else "?",
                    "error": f"entry failed: {str(e)[:160]}"}

    # cari on-device engine time (detail only, excluded from the median: at
    # 400x1200 the launch overhead dominates)
    _mark("cari scipy gate done, timing cari engine")
    dflow = "element" if res.engine_used == "element" else "spada"
    dev = measure_device_perf(w.a, w.b, config, dataflow=dflow)
    cari_detail = {"name": "cari", "engine": dev["engine"],
                   "in_median": False,
                   "elapsed_ms": round(dev["engine_s"] * 1e3, 4),
                   "gflops": round(dev["flops_per_s"] / 1e9, 1)}

    entries = []

    _mark("cari gates done, generating banded")
    a = _cached_workload("banded-64k-384-s0", lambda: banded_csr(
        65536, 65536, bandwidth=384, seed=0, dtype=np.float32))
    b = _cached_workload("banded-64k-384-s1", lambda: banded_csr(
        65536, 65536, bandwidth=384, seed=1, dtype=np.float32))
    entries.append(guard(_tile_entry, "banded", a, b, config, None, peaks))

    _mark("generating banded_off")
    a = _cached_workload("bandedoff-64k-384-192-s0", lambda: banded_offset_csr(
        65536, 65536, 384, 192, seed=0, dtype=np.float32))
    b = _cached_workload("bandedoff-64k-384-192-s1", lambda: banded_offset_csr(
        65536, 65536, 384, 192, seed=1, dtype=np.float32))
    entries.append(guard(
        _tile_entry, "banded_off", a, b, config, None, peaks, densify=True))

    _mark("generating locpl")
    a = _cached_workload("locpl-64k-32-s1", lambda: localized_powerlaw_csr(
        65536, 65536, 32.0, seed=1, dtype=np.float32))
    b = _cached_workload("locpl-64k-32-s2", lambda: localized_powerlaw_csr(
        65536, 65536, 32.0, seed=2, dtype=np.float32))
    entries.append(guard(_element_entry, "locpl", a, b, config, peaks))

    _mark("generating rmat")
    a = _cached_workload("rmat-32k-12-s1",
                         lambda: rmat_csr(32768, 12.0, seed=1,
                                          dtype=np.float32))
    b = _cached_workload("rmat-32k-12-s2",
                         lambda: rmat_csr(32768, 12.0, seed=2,
                                          dtype=np.float32))
    entries.append(guard(_element_entry, "rmat", a, b, config, peaks))

    # NN category (the reference's second workload mode, py2rust.rs:62-97):
    # block-pruned weight (16384^2, 384-blocks, 20% kept — structured
    # magnitude pruning) x ReLU-sparse activation batch (35% dense)
    _mark("generating nn")
    a = _cached_workload("nnblock-16k-384-p2-s5", lambda: block_sparse_csr(
        16384, 16384, 384, 0.2, seed=5, dtype=np.float32))
    b = _cached_workload("nnrelu-16k-4k-p35-s6", lambda: relu_activation_csr(
        16384, 4096, 0.35, seed=6, dtype=np.float32))
    entries.append(guard(_tile_entry, "nn", a, b, config, 384, peaks))

    # real-structure PDE workloads: exact stencil Laplacians, generated
    # deterministically, C = A @ A (square => B=A, gemm.rs:41-53); engine
    # chosen by dispatch_dataflow
    _mark("generating stencil5 (2-D, n=2.36M)")
    a = _cached_workload("lap5-1536x1536", lambda: stencil_5pt_csr(
        1536, 1536, dtype=np.float32))
    entries.append(guard(_entry_dispatched, "stencil5", a, a, config, peaks))

    _mark("generating stencil7 (3-D, n=2.1M)")
    a = _cached_workload("lap7-128c", lambda: stencil_7pt_csr(
        128, 128, 128, dtype=np.float32))
    entries.append(guard(_entry_dispatched, "stencil7", a, a, config, peaks))

    _mark("second pass")
    _second_pass(entries, config)
    _mark("calibration")
    cal = _calibrate()
    for e in entries:
        e.pop("_retime", None)

    summary, detail = _summarize(entries, cari_detail, cal,
                                 {**device_info(), "nvidia_smi": smi})
    if detail is not None:
        out_dir = os.environ.get("SPADA_OUT_DIR",
                                 os.path.join(_CACHE_ROOT, "out"))
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "BENCH_DETAIL.json"), "w") as f:
            json.dump(detail, f, indent=1)
    print(json.dumps(summary))
    return 0 if "error" not in summary and not any(
        "error" in e for e in entries) else 1


def _summarize(entries, cari_detail, cal, device):
    """(compact stdout summary, full detail) — the headline aggregation.

    The compact line is the machine-readable record; everything bulky
    lives in the detail dict (written to BENCH_DETAIL.json).
    Headline ``value`` = suite median of per-entry ``pct_binding``;
    ``value_naive`` = the median against the naive streaming bound."""
    ok = [e for e in entries if "pct_sol" in e]
    errs = [e for e in entries if "error" in e]
    if not ok:
        return ({
            "metric": "spgemm_pct_binding", "value": 0.0, "unit": "%",
            "vs_baseline": 0.0,
            "error": "; ".join(f"{e['name']}: {e['error']}" for e in errs),
        }, None)
    # a numerics GATE failure anywhere zeroes the headline (a fast wrong
    # kernel must not score); any other failure drops its entry but needs
    # >=3 survivors for a median (and fails the run's exit code)
    gate_fail = any("gate failed" in e["error"] for e in errs)
    zero = gate_fail or len(ok) < 3
    value = 0.0 if zero else float(np.median(
        [e["pct_binding"] for e in ok]))
    value_naive = 0.0 if zero else float(np.median(
        [e["pct_sol"] for e in ok]))

    detail = {
        "device": device,
        "aggregation": "median over suite of per-workload pct_binding "
                       "(each entry vs its own binding bound, capped at "
                       "100; best of two timing passes per entry); "
                       "value_naive is the naive-streaming median",
        "suite": entries,
        "cari": cari_detail,
        "calibration": cal,
    }
    summary = {
        "metric": "spgemm_pct_binding",
        "value": round(value, 2),
        "unit": "%",
        "vs_baseline": round(value / 70.0, 4),
        "value_naive": round(value_naive, 2),
        "device": device,
        "suite": [
            {"name": e["name"], "engine": e.get("engine", "?"),
             "ms": e.get("elapsed_ms"), "pct_sol": e.get("pct_sol"),
             "pct_binding": e.get("pct_binding"),
             **({"error": e["error"][:80]} if "error" in e else {})}
            for e in entries
        ],
        "detail_file": "BENCH_DETAIL.json",
    }
    return summary, detail


if __name__ == "__main__":
    if os.environ.get("SPADA_BENCH_CHILD"):
        sys.exit(main())
    sys.exit(_watchdog_main())
