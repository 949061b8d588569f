"""Time the tile kernel against the XLA tile engine, and the XLA element
executor against its HBM bound, on the GPU.

    python tools/kernel_decision.py --check   # compile at real width, compare once, stop
    python tools/kernel_decision.py           # the measurements of PERF.md "Kernel decisions"

Both tile engines take the same bf16 tiles and row-ordered worklist on the
device and produce f32 C tiles on the device; each timing is the median of
repeated calls that each end in ``block_until_ready``, after warm-up.
Results go to ``kernel_decision.json`` in ``$SPADA_OUT_DIR`` (default
``out/`` at the repo root).  Fails without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.environ.get("SPADA_OUT_DIR", os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "out"))


def _time(fn, n: int = 10, warm: int = 2) -> dict:
    import jax

    for _ in range(warm):
        jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return {"median_s": float(np.median(ts)), "min_s": float(min(ts)),
            "max_s": float(max(ts))}


def _operands(name: str):
    from spada_tpu.io.workloads import (banded_csr, block_sparse_csr,
                                        relu_activation_csr)

    if name == "nn":
        return (block_sparse_csr(16384, 16384, 384, 0.2, seed=5),
                relu_activation_csr(16384, 4096, 0.35, seed=6))
    a = banded_csr(65536, 65536, 384, dtype=np.float32)
    return a, a


def _prepare(a, b, T: int):
    import jax.numpy as jnp

    from spada_tpu.ops.engine import run_pointer
    from spada_tpu.ops.worklist import build_worklist
    from spada_tpu.sparse.bsr import BsrMatrix

    a_bsr = BsrMatrix.from_csr(a, T, T, dtype=jnp.bfloat16)
    b_bsr = BsrMatrix.from_csr(b, T, T, dtype=jnp.bfloat16)
    wl = build_worklist(a_bsr, b_bsr, order="row")
    dev = dict(at=jnp.asarray(a_bsr.tiles), bt=jnp.asarray(b_bsr.tiles),
               ai=jnp.asarray(wl.a_tid), bi=jnp.asarray(wl.b_tid),
               oi=jnp.asarray(wl.o_tid),
               ptr=jnp.asarray(run_pointer(wl.o_tid, wl.n_c_tiles)))
    W, nC = wl.n_items, wl.n_c_tiles
    meta = {"T": T, "W": int(W), "n_c_tiles": int(nC),
            "n_a_tiles": int(a_bsr.tiles.shape[0]),
            "n_b_tiles": int(b_bsr.tiles.shape[0]),
            "flops": 2 * W * T ** 3,
            "bytes_per_item_read": W * 2 * T * T * 2 + nC * T * T * 4,
            "bytes_unique": (a_bsr.tiles.shape[0] + b_bsr.tiles.shape[0])
            * T * T * 2 + nC * T * T * 4}
    return dev, meta


def _engines(dev, nC, blocks=None):
    from spada_tpu.ops.engine import _run_triton, _run_xla

    blocks = blocks or {}

    def kernel():
        return _run_triton(dev["ptr"], dev["ai"], dev["bi"], dev["at"],
                           dev["bt"], n_c_tiles=nC, precision="default",
                           **blocks)

    def xla():
        return _run_xla(dev["ai"], dev["bi"], dev["oi"], dev["at"],
                        dev["bt"], n_c_tiles=nC, precision="default")

    return kernel, xla


def _relerr(x, ref) -> float:
    import jax.numpy as jnp

    return float(jnp.max(jnp.abs(x - ref)) / jnp.max(jnp.abs(ref)))


def check() -> dict:
    """Compile the kernel at real width, compare with XLA once, print the
    compiled program's memory analysis."""
    import jax

    from spada_tpu.ops.engine import _run_triton

    a, b = _operands("nn")
    dev, meta = _prepare(a, b, 384)
    nC = meta["n_c_tiles"]
    kernel, xla = _engines(dev, nC)
    lowered = jax.jit(lambda *xs: _run_triton(*xs, n_c_tiles=nC)).lower(
        dev["ptr"], dev["ai"], dev["bi"], dev["at"], dev["bt"])
    mem = lowered.compile().memory_analysis()
    print("memory_analysis:", mem, flush=True)
    err = _relerr(kernel(), xla())
    print(f"nn T=384 kernel vs XLA: relerr {err:.3e} (bf16 tiles, f32 "
          f"accumulation; limit 2e-2)", flush=True)
    return {"meta": meta, "relerr": err, "memory_analysis": str(mem)}


BLOCK_CONFIGS = [
    dict(bm=128, bn=128, bk=64, num_warps=8, num_stages=3),
    dict(bm=128, bn=128, bk=64, num_warps=4, num_stages=3),
    dict(bm=128, bn=128, bk=32, num_warps=4, num_stages=4),
    dict(bm=64, bn=128, bk=64, num_warps=4, num_stages=3),
    dict(bm=128, bn=64, bk=64, num_warps=4, num_stages=3),
    dict(bm=64, bn=64, bk=64, num_warps=4, num_stages=4),
]


def measure() -> dict:
    import jax
    import jax.numpy as jnp

    from spada_tpu.config import SpadaConfig
    from spada_tpu.plan.planner import choose_tile_size

    res = {"tile": [], "blocks": []}
    cfg = SpadaConfig.fast()

    # block sweep on nn at T = 384
    a, b = _operands("nn")
    dev, meta = _prepare(a, b, 384)
    _, xla = _engines(dev, meta["n_c_tiles"])
    ref = xla()
    for blk in BLOCK_CONFIGS:
        kernel, _ = _engines(dev, meta["n_c_tiles"], blk)
        try:
            err = _relerr(kernel(), ref)
            t = _time(kernel)
        except Exception as e:  # a config the compiler refuses
            res["blocks"].append({**blk, "error": str(e)[:200]})
            print("blocks", blk, "failed:", str(e)[:200], flush=True)
            continue
        res["blocks"].append({**blk, "relerr": err, **t})
        print("blocks", blk, f"{t['median_s']*1e3:.3f} ms relerr {err:.2e}",
              flush=True)
    ok = [r for r in res["blocks"] if "median_s" in r]
    best = min(ok, key=lambda r: r["median_s"])
    best_blocks = {k: best[k] for k in BLOCK_CONFIGS[0]}
    res["best_blocks"] = best_blocks
    del dev, ref

    for name in ("nn", "banded"):
        a, b = _operands(name) if name != "nn" else (a, b)
        t_plan, det = choose_tile_size(a, b, cfg)
        res[f"{name}_planner_T"] = t_plan
        for T in (128, 256, 384, 512):
            dev, meta = _prepare(a, b, T)
            nC = meta["n_c_tiles"]
            kernel, xla = _engines(dev, nC, best_blocks)
            row = {"operands": name, **meta,
                   "model_t_est_s": det[T]["t_est"],
                   "planner_choice": T == t_plan}
            row["relerr"] = _relerr(kernel(), xla())
            row["kernel"] = _time(kernel)
            if T in (384, t_plan):
                row["xla"] = _time(xla)
            res["tile"].append(row)
            print(name, f"T={T} W={meta['W']} kernel "
                  f"{row['kernel']['median_s']*1e3:.3f} ms"
                  + (f" xla {row['xla']['median_s']*1e3:.3f} ms"
                     if "xla" in row else ""), flush=True)
            del dev
        del a, b

    # element executor on stencil7 (C = A.A)
    from spada_tpu.io.workloads import stencil_7pt_csr
    from spada_tpu.ops.element import (_esc_runner, build_esc_plan,
                                       esc_operands, esc_transfer)

    a = stencil_7pt_csr(128, 128, 128, dtype=np.float32)
    t0 = time.perf_counter()
    plan = build_esc_plan(a, a)
    ops = esc_transfer(esc_operands(plan, a, a))
    host_s = time.perf_counter() - t0
    run = _esc_runner()
    t = _time(lambda: run(ops))
    nbytes = plan.operand_bytes()
    res["element_stencil7"] = {
        "e_products": int(plan.n_products), "n_padded": int(plan.n_padded),
        "operand_bytes": int(nbytes), "host_plan_upload_s": host_s, **t,
        "share_of_3_35_TBps": nbytes / 3.35e12 / t["median_s"]}
    print(f"element stencil7: {t['median_s']*1e3:.3f} ms, "
          f"{nbytes/1e9:.3f} GB, share of 3.35 TB/s "
          f"{res['element_stencil7']['share_of_3_35_TBps']:.3f}", flush=True)
    del ops

    # what a large plain bf16 product and a large copy reach on this card
    x = jnp.ones((8192, 8192), jnp.bfloat16)
    mm = jax.jit(lambda x: jnp.dot(x, x, preferred_element_type=jnp.float32))
    t = _time(lambda: mm(x))
    res["ref_bf16_matmul_tflops"] = 2 * 8192 ** 3 / t["median_s"] / 1e12
    y = jnp.ones((256 * 2 ** 20,), jnp.float32)
    cp = jax.jit(lambda y: y * 2.0)
    t = _time(lambda: cp(y))
    res["ref_copy_tbps"] = 2 * y.size * 4 / t["median_s"] / 1e12
    print(f"reference: bf16 matmul {res['ref_bf16_matmul_tflops']:.1f} "
          f"TFLOP/s, copy {res['ref_copy_tbps']:.3f} TB/s", flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()

    import jax

    from spada_tpu.platform import (device_info, nvidia_smi_line,
                                    require_gpu, setup_compile_cache)

    require_gpu("kernel_decision")
    cache = setup_compile_cache()
    out = {"nvidia_smi": nvidia_smi_line(), "jax": jax.__version__,
           "device": device_info(), "compile_cache": cache}
    print(json.dumps(out), flush=True)
    out.update(check() if args.check else measure())
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "kernel_decision" + ("_check" if args.check
                                                  else "") + ".json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
