"""Command-line driver.

Mirrors the reference CLI ergonomics
(``spada-sim <mode> <accelerator> <category> <workload> <config> [-p]``,
frontend.rs:52-75 + main.rs:30-121) with real execution modes:

- ``run``      execute the SpGEMM on JAX's default device (the GPU, or the
               CPU in tests) and report perf + modeled traffic — the
               rebuild of ``AccurateSimu``.
- ``traffic``  functional traffic model only (no device): the capability of
               the legacy ``TrafficModel`` mode (storage_traffic_model.rs).
- ``breuse``   B/C-reuse analysis — implements the ``BReuseCounter`` mode the
               reference advertises but panics on (main.rs:119).
- ``plan``     show the adaptive planner's decisions without executing.

Dataflow argument maps the accelerator enum (frontend.rs:36-41):
``ip | op | rowwise (MultiRow) | spada``.  Category is ``SS`` (SuiteSparse
.mtx under ``ss_filepath``) or ``NN`` (pickled {name: (A, B)} GEMMs at
``nn_filepath``, py2rust.rs:5-60).  ``-p`` applies ascending-row-nnz
preprocessing (preprocessing.rs:76-89).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from spada_tpu.config import SpadaConfig
from spada_tpu.io.workloads import GemmWorkload, load_pickled_gemms
from spada_tpu.utils.metrics import PerfReport, format_report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spada_tpu",
        description="adaptive-dataflow SpGEMM on JAX (spada-sim rebuilt)",
    )
    p.add_argument("mode", choices=["run", "traffic", "breuse", "plan"])
    p.add_argument("dataflow",
                   choices=["ip", "op", "rowwise", "spada", "element"],
                   help="dataflow / accelerator analog (element = "
                        "ESC engine for scattered sparsity)")
    p.add_argument("category", choices=["SS", "NN", "ss", "nn"])
    p.add_argument("workload", help="matrix name (SS) or gemm name (NN)")
    p.add_argument("config", nargs="?", default=None, help="config JSON path")
    p.add_argument("-p", "--preprocess", action="store_true",
                   help="row-nnz-ascending reorder (preprocessing.rs:76-89)")
    p.add_argument("--no-result", action="store_true",
                   help="skip printing the first rows of C")
    p.add_argument("--window-k", type=int, default=None,
                   help="traffic mode: A-scalars per window (default full-K)")
    p.add_argument("--engine", default=None,
                   choices=["auto", "xla", "triton"],
                   help="tile engine override (default: config/auto)")
    p.add_argument("--dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="tile dtype override (bfloat16 implies "
                        "precision=default)")
    p.add_argument("--fast", action="store_true",
                   help="throughput profile: bf16 tiles + adaptive tile size")
    p.add_argument("--densify", default="auto", choices=["auto", "off"],
                   help="plan-time layout densification: k-grid anchor scan "
                        "+ degree-clustering permutations (plan/densify.py); "
                        "auto keeps identity when structure is already "
                        "aligned")
    p.add_argument("--plan-scheme", default="analytic",
                   choices=["analytic", "profiled"],
                   help="spada panel planner: closed-form byte model or "
                        "measured kernel latency (rowwise_perf_adjust.rs "
                        "scheme-3 signal)")
    return p


def load_workload(args, config: SpadaConfig) -> GemmWorkload:
    if args.category.upper() == "SS":
        w = GemmWorkload.from_suitesparse(config.ss_filepath, args.workload)
    else:
        import os

        if not os.path.exists(config.nn_filepath):
            # the reference ships no NN pickle (py2rust.rs:5-60 just reads
            # one); generate the stock pruned-layer GEMMs on first use so
            # `run spada NN <layer>` works out of the box
            from spada_tpu.models.nn_workloads import write_nn_pickle

            print(f"generating NN workloads -> {config.nn_filepath}")
            write_nn_pickle(config.nn_filepath)
        w = load_pickled_gemms(config.nn_filepath, args.workload)
    if args.preprocess:
        w = w.preprocess_sorted()
    return w


def _print_gemm_stats(w: GemmWorkload) -> None:
    print(f"GEMM {w.name}: A {w.a.shape} nnz {w.a.nnz}  "
          f"B {w.b.shape} nnz {w.b.nnz}"
          + ("  [preprocessed]" if w.row_remap is not None else ""))


def _print_first_rows(c, w: GemmWorkload, n: int = 10) -> None:
    """First <=10 rows of C in original row ids (main.rs:113-116)."""
    c = w.restore_row_order(c)
    for i in range(min(n, c.shape[0])):
        cols, vals = c.row(i)
        head = ", ".join(
            f"({int(j)}: {v:.4g})" for j, v in list(zip(cols, vals))[:8]
        )
        more = " ..." if len(cols) > 8 else ""
        print(f"  C[{i}] ({len(cols)} nnz): {head}{more}")


def cmd_run(args, config: SpadaConfig, w: GemmWorkload) -> int:
    import time

    from spada_tpu.models.traffic import simulate_traffic
    from spada_tpu.ops.spgemm import measure_device_perf, spgemm
    from spada_tpu.platform import device_info, device_line

    dev_info = device_info()
    on_gpu = dev_info["platform"] == "gpu"
    print(device_line())
    dataflow = args.dataflow
    plan = None
    if dataflow == "spada" and config.element_dispatch != "never":
        from spada_tpu.ops.spgemm import dispatch_dataflow

        choice, det = dispatch_dataflow(w.a, w.b, config)
        if choice == "element" or config.element_dispatch == "always":
            print(f"dataflow dispatch: element "
                  f"(E={det['element']['e_products']}, modeled "
                  f"{det['element']['t_est']*1e3:.2f}ms vs tile "
                  f"{min(v['t_est'] for v in det['tile'].values())*1e3:.2f}ms)")
            dataflow = "element"
    if dataflow == "spada":
        from spada_tpu.plan.planner import choose_tile_size, plan_spgemm

        t_best, t_det = choose_tile_size(w.a, w.b, config)
        if getattr(args, "densify", "off") == "auto":
            # score candidates at the tile size the run will actually use
            # (tm too: the cost model's work-item counts depend on it)
            w2, dplan = w.preprocess_densified(config, tm=t_best, tk=t_best,
                                               tn=t_best)
            if not dplan.is_identity:
                print(f"densify: {dplan.candidate}  "
                      f"(W {dplan.modeled['all']} modeled-ms per layout; "
                      f"tiles A={dplan.modeled['n_a_tiles']} "
                      f"B={dplan.modeled['n_b_tiles']} "
                      f"items={dplan.modeled['w']})")
                w = w2
                t_best, t_det = choose_tile_size(w.a, w.b, config)
            else:
                print("densify: identity (structure already aligned)")
        if t_best != config.tile_k:
            config.tile_k = config.tile_n = t_best
            config.default_tm = t_best
            config.tm_choices = tuple(
                t for t in config.tm_choices if t <= t_best
            ) + (t_best,)
        ests = ", ".join(
            f"{k}: {v['t_est'] * 1e3:.2f}ms" for k, v in t_det.items()
        )
        print(f"tile size: {t_best}  (model: {ests})")
        measure = None
        if args.plan_scheme == "profiled":
            from spada_tpu.plan.planner import make_profiled_measure

            measure = make_profiled_measure(w.a, w.b, config)
        plan = plan_spgemm(w.a, w.b, config, scheme=args.plan_scheme,
                           measure=measure)
        print(f"plan[{args.plan_scheme}]: {len(plan.panels)} panels, "
              f"tm histogram {plan.tm_histogram()}")
    elif dataflow == "op":
        from spada_tpu.plan.planner import plan_op_dataflow

        op_tm, op_det = plan_op_dataflow(w.a, w.b, config)
        print(f"colwise plan (scheme {op_det['scheme']}): panel height "
              f"{op_tm} from {op_det['anchors']} anchors, "
              f"window-height votes {op_det['heights']}")

    # ONE execution produces the result; its retained host_state (plan,
    # BSR tiles, worklists) feeds the device timing directly, so a run is
    # one plan build + one engine dispatch + one timed loop (the reference
    # also executes once then reports, main.rs:93-116)
    res = spgemm(w.a, w.b, config, dataflow=dataflow, plan=plan)

    t_rb = time.perf_counter()
    c = res.to_csr()
    readback_s = time.perf_counter() - t_rb

    if on_gpu:
        # device time of the engine that ran, on the card; a failure here
        # is a failure of the run (no fallback to wall clock)
        dev = measure_device_perf(
            w.a, w.b, config, dataflow=dataflow, plan=plan,
            host_state=getattr(res, "host_state", None))
    else:
        dev = None
    if dev is None:
        # CPU (or nothing to time on the card): re-run once warmed so the
        # wall-clock report is steady-state, not compile time
        res2 = spgemm(w.a, w.b, config, dataflow=dataflow, plan=plan)
        elapsed_for_report = res2.elapsed_s
    else:
        elapsed_for_report = dev["engine_s"]
        share = (f"{dev['pct_flops_peak']:.1f}% of peak FLOP/s"
                 if dev.get("pct_flops_peak") is not None
                 else f"{dev['pct_hbm_peak']:.1f}% of peak HBM")
        print(f"device perf ({dev['device_kind']}, engine {dev['engine']}): "
              f"{dev['engine_s']*1e3:.3f} ms | "
              f"{dev['flops_per_s']/1e9:.1f} GFLOP/s ({share}) | "
              f"model HBM {dev['hbm_gbps']:.0f} GB/s | "
              f"result readback+extract {readback_s:.2f} s (excluded)")

    perf = PerfReport(
        workload=w.name, dataflow=dataflow, elapsed_s=elapsed_for_report,
        useful_flops=res.useful_flops, mxu_flops=res.mxu_flops, nnz_c=c.nnz,
        hbm_bytes_model=_tile_bytes(res), n_work_items=res.n_work_items,
        backend=dev_info["platform"],
        device_kind=dev_info["kind"] if dev is not None else None,
        tile_itemsize=2 if config.engine_dtype == "bfloat16" else 4,
        precision=config.precision,
    )
    traffic = simulate_traffic(
        w.a, w.b, config, compute_values=False
    ).report
    print(format_report(perf, traffic))
    if not args.no_result:
        _print_first_rows(c, w)
    return 0


def _tile_bytes(res) -> int:
    """Tile-engine HBM byte model: A+B tiles per work item, C tiles once.

    Uses the actual contraction tile edge and tile dtype the engine ran with
    (T may be re-chosen per matrix by choose_tile_size, and bf16 tiles move
    half the bytes of f32).
    """
    if getattr(res, "element", None) is not None:  # ESC element path
        el = res.element
        return (el.plan.operand_bytes() if hasattr(el, "plan")
                else el.operand_bytes())
    if hasattr(res, "segments"):  # PlanResult
        total = 0
        for seg in res.segments:
            r = seg.result
            total += (r.n_work_items * (seg.tm * r.tk + r.tk * r.tn)
                      * r.tile_itemsize)
            total += np.asarray(r.c_tiles).shape[0] * seg.tm * r.tn * 4
        return total
    tiles = np.asarray(res.c_tiles)
    return (res.n_work_items * (res.tm * res.tk + res.tk * res.tn)
            * res.tile_itemsize
            + tiles.shape[0] * res.tm * res.tn * 4)


def cmd_traffic(args, config: SpadaConfig, w: GemmWorkload) -> int:
    from spada_tpu.models.traffic import simulate_traffic

    res = simulate_traffic(w.a, w.b, config, window_k=args.window_k)
    print("functional traffic model (reference counter semantics):")
    for k, v in res.report.as_dict().items():
        print(f"  {k}: {v}")
    from spada_tpu.ops.spgemm import _count_useful_flops

    mults = _count_useful_flops(w.a, w.b) // 2
    print(f"  estimated_cycles: "
          f"{res.report.estimated_cycles(config, useful_mults=mults)}"
          f"  (machine: {config.pe_num} PEs x {config.lane_num} lanes, "
          f"{config.bandwidth_bytes_per_cycle:.0f} B/cyc)")
    if not args.no_result:
        _print_first_rows(res.c, w)
    return 0


def cmd_breuse(args, config: SpadaConfig, w: GemmWorkload) -> int:
    from spada_tpu.models.traffic import simulate_traffic

    res = simulate_traffic(w.a, w.b, config, compute_values=False)
    r = res.report
    print(f"b_reuse: {r.b_reuse:.4f}  (touched {r.b_touched_words} / "
          f"distinct {r.b_distinct_words} words)")
    print(f"c_reuse: {r.c_reuse:.4f}  (touched {r.c_touched_words} / "
          f"final {r.c_final_words} words)")
    print(f"cache hit ratio: "
          f"{1 - r.cache.miss_count / max(r.b_touched_words, 1):.4f}")
    return 0


def cmd_plan(args, config: SpadaConfig, w: GemmWorkload) -> int:
    from spada_tpu.plan.planner import plan_spgemm

    measure = None
    if args.plan_scheme == "profiled":
        from spada_tpu.plan.planner import make_profiled_measure

        measure = make_profiled_measure(w.a, w.b, config)
    plan = plan_spgemm(w.a, w.b, config, scheme=args.plan_scheme,
                       measure=measure)
    print(f"{len(plan.panels)} panels over {w.a.shape[0]} rows "
          f"({plan.meta['n_groups']} row groups, "
          f"scheme {args.plan_scheme})")
    print(f"tm histogram (height -> rows): {plan.tm_histogram()}")
    for p in plan.panels[:20]:
        print(f"  rows [{p.row_start}, {p.row_end})  tm={p.tm}")
    if len(plan.panels) > 20:
        print(f"  ... {len(plan.panels) - 20} more")
    return 0


def main(argv=None) -> int:
    from spada_tpu.platform import setup_compile_cache

    args = build_parser().parse_args(argv)
    setup_compile_cache()
    config = SpadaConfig.from_json(args.config) if args.config else SpadaConfig()
    config.dataflow = args.dataflow
    if args.fast:
        config.engine_dtype = "bfloat16"
        config.precision = "default"
    if args.engine:
        config.engine = args.engine
    if args.dtype:
        config.engine_dtype = args.dtype
        if args.dtype == "bfloat16":
            config.precision = "default"
    w = load_workload(args, config)
    _print_gemm_stats(w)
    return {
        "run": cmd_run, "traffic": cmd_traffic,
        "breuse": cmd_breuse, "plan": cmd_plan,
    }[args.mode](args, config, w)


if __name__ == "__main__":
    sys.exit(main())
