"""Execution metrics and roofline reporting.

The reference emits counter totals at the end of a run (main.rs:102-111:
exec cycles, A/B/C read+write element counts, cache read/write).  The rebuild
reports the same counters through the functional traffic model
(:mod:`spada_tpu.models.traffic`) and adds measured metrics: GFLOP/s,
nnz(C)/s, modeled HBM bytes and, for a run on a device in the peak table
(:mod:`spada_tpu.platform`), the share of that device's roofline.  A CPU
run is labelled CPU wall clock and gets no roofline share.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional



@dataclasses.dataclass
class PerfReport:
    """Hardware-execution report for one SpGEMM."""

    workload: str
    dataflow: str
    elapsed_s: float
    useful_flops: int          # 2 * scalar multiply count
    mxu_flops: int             # tile FLOPs issued (incl. tile padding)
    nnz_c: int
    hbm_bytes_model: int       # tile-engine byte model (A+B tiles, C once)
    n_work_items: int = 0
    backend: str = "cpu"
    device_kind: Optional[str] = None   # row of the peak table (GPU runs)
    tile_itemsize: int = 4
    precision: str = "highest"

    @property
    def useful_gflops(self) -> float:
        return self.useful_flops / max(self.elapsed_s, 1e-12) / 1e9

    @property
    def mxu_gflops(self) -> float:
        return self.mxu_flops / max(self.elapsed_s, 1e-12) / 1e9

    @property
    def nnz_c_per_s(self) -> float:
        return self.nnz_c / max(self.elapsed_s, 1e-12)

    @property
    def density_efficiency(self) -> float:
        """Useful / issued FLOPs — how well tiles are packed (the analog of
        the reference's multiplier utilization, simulator.rs:762-775)."""
        return self.useful_flops / max(self.mxu_flops, 1)

    def sol_seconds(self) -> Optional[float]:
        """Roofline time bound on the device the run used: max(HBM time,
        FLOP time) at its published peaks; None unless it was timed on a
        device of the peak table."""
        if self.device_kind is None:
            return None
        from spada_tpu.platform import peaks_for

        peaks = peaks_for(self.device_kind)
        t_mem = self.hbm_bytes_model / peaks.hbm_bytes_per_s
        t_flop = self.mxu_flops / peaks.flops(self.tile_itemsize,
                                              self.precision)
        return max(t_mem, t_flop)

    def pct_of_sol(self) -> Optional[float]:
        sol = self.sol_seconds()
        return None if sol is None else sol / max(self.elapsed_s, 1e-12)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(
            useful_gflops=self.useful_gflops,
            mxu_gflops=self.mxu_gflops,
            nnz_c_per_s=self.nnz_c_per_s,
            density_efficiency=self.density_efficiency,
            pct_of_sol=self.pct_of_sol(),
        )
        return d

    def json_line(self) -> str:
        return json.dumps(self.as_dict())


def format_report(perf: PerfReport, traffic=None) -> str:
    """Human-readable end-of-run report (the rebuild's main.rs:95-116)."""
    clock = ("device time" if perf.device_kind
             else f"{perf.backend.upper()} wall clock")
    pct = perf.pct_of_sol()
    lines = [
        f"workload: {perf.workload}   dataflow: {perf.dataflow}   "
        f"backend: {perf.backend}"
        + (f" ({perf.device_kind})" if perf.device_kind else ""),
        f"elapsed ({clock}): {perf.elapsed_s*1e3:.3f} ms   "
        f"useful: {perf.useful_gflops:.2f} GFLOP/s   "
        f"tile: {perf.mxu_gflops:.2f} GFLOP/s   "
        f"nnz(C)/s: {perf.nnz_c_per_s:.3e}",
        f"work items: {perf.n_work_items}   nnz(C): {perf.nnz_c}   "
        f"tile packing: {perf.density_efficiency*100:.2f}%"
        + (f"   %-of-SoL: {pct*100:.1f}%" if pct is not None else ""),
    ]
    if traffic is not None:
        t = traffic.as_dict()
        lines += [
            "traffic model (reference counter semantics):",
            f"  A read: {t['a_mem_read']}   B read: {t['b_mem_read']}   "
            f"C read: {t['psum_mem_read']}   C write: {t['psum_mem_write']}",
            f"  cache read: {t['cache_read']}   cache write: {t['cache_write']}   "
            f"miss: {t['miss_count']}   b_evict: {t['b_evict_count']}   "
            f"psum_evict: {t['psum_evict_count']}",
            f"  b_reuse: {t['b_reuse']:.3f}   c_reuse: {t['c_reuse']:.3f}   "
            f"modeled DRAM: {t['dram_bytes']/1e6:.2f} MB",
        ]
    return "\n".join(lines)
