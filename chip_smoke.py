"""Smoke test of the system's main path on the GPU.

    python chip_smoke.py          # one card: CLI, tile, element, f32 phases
    python chip_smoke.py --four   # four cards: the multi-device paths only

Runs in one process, through the entry points a user calls, at real widths,
and compares every phase with a plain reference that shares no code with
the path under test.  Any failure ends the run with a non-zero exit code;
no phase is caught and passed over.  The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

and it is printed only when every phase passed.  Without a GPU the script
exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time

import numpy as np

TILE_RTOL = 2e-2      # bf16 tiles, f32 accumulation
ELEMENT_RTOL = 1e-4   # f32 products and sums, no dot


def result_line(device: dict) -> str:
    """The last line: ok and the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


def check(name: str, err: float, tol: float, wall_s: float, engine: str):
    print(f"phase {name}: engine {engine}  relerr {err:.3e} "
          f"(tolerance {tol:g})  wall {wall_s:.2f} s", flush=True)
    if not err < tol:
        raise AssertionError(f"phase {name}: relerr {err:.3e} >= {tol:g}")


def nn_operands():
    """The pruned-layer operands: a 20%-kept 384-block-sparse weight times
    35%-dense ReLU activations."""
    from spada_tpu.io.workloads import block_sparse_csr, relu_activation_csr

    return (block_sparse_csr(16384, 16384, 384, 0.2, seed=5),
            relu_activation_csr(16384, 4096, 0.35, seed=6))


def stencil7():
    from spada_tpu.io.workloads import stencil_7pt_csr

    return stencil_7pt_csr(128, 128, 128, dtype=np.float32)


def dense_reference(a, b):
    """A @ B from the densified operands, jnp.dot at HIGHEST on the card."""
    import jax
    import jax.numpy as jnp

    ad = jnp.asarray(a.todense(), jnp.float32)
    bd = jnp.asarray(b.todense(), jnp.float32)
    c = jnp.dot(ad, bd, precision=jax.lax.Precision.HIGHEST)
    del ad, bd
    return c


def device_relerr(c_host, ref_dev) -> float:
    import jax.numpy as jnp

    c = jnp.asarray(c_host, jnp.float32)
    return float(jnp.max(jnp.abs(c - ref_dev)) / jnp.max(jnp.abs(ref_dev)))


def sparse_relerr(got, ref) -> float:
    """relerr of two scipy sparse matrices (difference taken sparsely)."""
    return float(abs(got - ref).max() / abs(ref).max())


def phase_cli():
    from spada_tpu.cli import main as cli_main

    for extra in ([], ["--fast"]):
        argv = ["run", "spada", "SS", "cari", "config/default.json",
                "--no-result"] + extra
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
        out = buf.getvalue()
        print(out, end="", flush=True)
        if rc != 0:
            raise AssertionError(f"cli {argv} returned {rc}")
        if "device: gpu" not in out or "device perf (" not in out:
            raise AssertionError(f"cli {argv}: no device line / device time")
        print(f"phase cli {' '.join(extra) or '(default)'}: rc 0  wall "
              f"{time.perf_counter() - t0:.2f} s", flush=True)


def phase_tile(a, b):
    from spada_tpu.config import SpadaConfig
    from spada_tpu.ops.engine import select_engine
    from spada_tpu.ops.spgemm import spgemm

    cfg = SpadaConfig.fast(element_dispatch="never")
    t0 = time.perf_counter()
    res = spgemm(a, b, cfg)
    c = res.todense()
    wall = time.perf_counter() - t0
    err = device_relerr(c, dense_reference(a, b))
    check("tile (nn, spgemm)", err, TILE_RTOL, wall,
          select_engine("row", cfg.precision))


def phase_element(a):
    from spada_tpu.config import SpadaConfig
    from spada_tpu.ops.spgemm import dispatch_dataflow, spgemm_csr

    cfg = SpadaConfig()
    choice, det = dispatch_dataflow(a, a, cfg)
    print(f"dispatch_dataflow(stencil7): {choice} (element "
          f"{det['element']['t_est']*1e3:.3f} ms vs tile "
          f"{min(v['t_est'] for v in det['tile'].values())*1e3:.3f} ms "
          f"modeled)", flush=True)
    t0 = time.perf_counter()
    got = spgemm_csr(a, a, cfg, dataflow="element").to_scipy()
    wall = time.perf_counter() - t0
    sa = a.to_scipy()
    check("element (stencil7, spgemm_csr)", sparse_relerr(got, sa @ sa),
          ELEMENT_RTOL, wall, "element-xla")


def phase_f32():
    import os

    from spada_tpu.config import SpadaConfig
    from spada_tpu.io.mtx import load_mtx
    from spada_tpu.io.workloads import GemmWorkload
    from spada_tpu.ops.spgemm import spgemm

    w = GemmWorkload.from_matrix("cari", load_mtx(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "matrices", "cari.mtx")))
    t0 = time.perf_counter()
    res = spgemm(w.a, w.b, SpadaConfig(), dataflow="spada")
    got = res.todense()
    wall = time.perf_counter() - t0
    ref = np.asarray(w.reference_product().todense())
    ok = np.allclose(got, ref, rtol=1e-4, atol=1e-3)
    print(f"phase f32 (cari, HIGHEST): engine {res.engine_used}/xla  "
          f"max abs err {np.abs(got - ref).max():.3e} (rtol 1e-4, "
          f"atol 1e-3)  wall {wall:.2f} s", flush=True)
    if not ok:
        raise AssertionError("phase f32: cari differs from scipy")


def memory_line(tag: str):
    import jax

    for d in jax.devices():
        st = d.memory_stats() or {}
        print(f"memory {tag} {d}: bytes_in_use "
              f"{st.get('bytes_in_use', 0)} peak_bytes_in_use "
              f"{st.get('peak_bytes_in_use', 0)}", flush=True)


def four_phases(a, b, s7):
    """The multi-device paths on four cards, each against its reference."""
    import jax
    from jax.sharding import Mesh

    from spada_tpu.parallel import (partition_element, partition_halo,
                                    partition_spgemm, spgemm_element_dp,
                                    spgemm_halo, spgemm_sharded)

    devs = np.array(jax.devices()[:4])
    # the dense reference C (f32, 268 MB) stays on the first card
    ref = dense_reference(a, b)

    t0 = time.perf_counter()
    prob = partition_spgemm(a, b, 2, 2)
    res = spgemm_sharded(prob, mesh=Mesh(devs.reshape(2, 2), ("dp", "tp")),
                         merge="reduce_scatter")
    memory_line("after spgemm_sharded")
    check("spgemm_sharded (nn, dp=2 tp=2, reduce_scatter)",
          device_relerr(res.todense(), ref), TILE_RTOL,
          time.perf_counter() - t0, "triton")
    del prob, res

    t0 = time.perf_counter()
    hprob = partition_halo(a, b, 4)
    hres = spgemm_halo(hprob, mesh=Mesh(devs, ("dp",)))
    memory_line("after spgemm_halo")
    check("spgemm_halo (nn, dp=4)", device_relerr(hres.todense(), ref),
          TILE_RTOL, time.perf_counter() - t0, "triton")
    del hprob, hres, ref

    t0 = time.perf_counter()
    eres = spgemm_element_dp(partition_element(s7, s7, 4),
                             mesh=Mesh(devs, ("dp",)))
    memory_line("after spgemm_element_dp")
    sa = s7.to_scipy()
    check("spgemm_element_dp (stencil7, dp=4)",
          sparse_relerr(eres.to_csr().to_scipy(), sa @ sa), ELEMENT_RTOL,
          time.perf_counter() - t0, "element-xla")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card multi-device phases")
    args = ap.parse_args(argv)

    import jax

    from spada_tpu.platform import (backend, device_info, nvidia_smi_line,
                                    setup_compile_cache)

    if backend() != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's backend is {backend()!r}",
              file=sys.stderr)
        return 2
    info = device_info()
    need = 4 if args.four else 1
    if info["count"] < need:
        print(f"chip_smoke: needs {need} GPUs, found {info['count']}",
              file=sys.stderr)
        return 2

    cache = setup_compile_cache()
    print(nvidia_smi_line(), flush=True)
    print(f"jax {jax.__version__}  device_kind {info['kind']}  devices "
          f"{info['count']}  compile cache {cache}", flush=True)

    t_all = time.perf_counter()
    a, b = nn_operands()
    s7 = stencil7()
    if args.four:
        four_phases(a, b, s7)
    else:
        phase_cli()
        phase_tile(a, b)
        phase_element(s7)
        phase_f32()
        memory_line("end")
    print(f"all phases passed in {time.perf_counter() - t_all:.1f} s",
          flush=True)
    print(result_line(info))
    return 0


if __name__ == "__main__":
    sys.exit(main())
