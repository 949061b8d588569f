"""Weak-scaling model: projected multi-device efficiency over NVLink.

The reference overlaps DRAM traffic with PE compute cycle-by-cycle
(simulator.rs:604-637); at the distributed axis the analogous question is
how much of the inter-device traffic (ppermute halo rounds, or the tp psum
merge) hides behind local compute.  This closed-form model answers it for
the modelled target (:data:`spada_tpu.platform.MODEL_TARGET`): per-device
compute time from the roofline of the busiest shard, with the tile
kernel's fitted share of peak, and communication time from the strategy's
planned bytes at the per-direction link rate.  Every GPU reaches every
other at that rate (NVLink all to all), so the model has no topology; the
halo strategy's transfers overlap the local-B segment compute (the
worklists are ordered local-first for exactly this reason,
spada_tpu.parallel.halo).

Weak-scaling efficiency at D devices = T_ideal / T_model where T_ideal is
the busiest shard's pure-compute time: 1.0 means communication fully
hidden and work perfectly balanced.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from spada_tpu.config import SpadaConfig
from spada_tpu.platform import MODEL_TARGET


@dataclasses.dataclass
class ScalingEstimate:
    strategy: str
    n_dev: int
    compute_s: float         # busiest shard's roofline compute time
    comm_s: float            # total link transfer time (rounds serialized)
    overlap_s: float         # portion hidden behind compute
    total_s: float           # modeled step time
    efficiency: float        # compute_s / total_s (weak-scaling efficiency)
    comm_bytes: int
    imbalance: float         # busiest / mean shard work

    def as_dict(self) -> dict:
        return {
            "strategy": self.strategy, "n_dev": self.n_dev,
            "compute_ms": round(self.compute_s * 1e3, 3),
            "comm_ms": round(self.comm_s * 1e3, 3),
            "overlap_ms": round(self.overlap_s * 1e3, 3),
            "total_ms": round(self.total_s * 1e3, 3),
            "efficiency": round(self.efficiency, 4),
            "comm_mb": round(self.comm_bytes / 1e6, 3),
            "imbalance": round(self.imbalance, 3),
        }


def _shard_compute_s(work_flops: np.ndarray, bytes_hbm: np.ndarray,
                     config: SpadaConfig) -> tuple:
    """Roofline time per shard -> (busiest shard s, imbalance ratio)."""
    t = np.maximum(work_flops / (config.engine_flops_share
                                 * MODEL_TARGET.bf16_flops),
                   bytes_hbm / MODEL_TARGET.hbm_bytes_per_s)
    busiest = float(t.max(initial=0.0))
    mean = float(t.mean()) if len(t) else 0.0
    return busiest, (busiest / mean if mean > 0 else 1.0)


def estimate_halo_scaling(problem, config: Optional[SpadaConfig] = None,
                          tile_itemsize: int = 2) -> ScalingEstimate:
    """Model the ppermute-ring halo strategy over NVLink.

    Round r ships D messages of cap_r tiles simultaneously (ppermute is a
    point-to-point shuffle: every device sends one message per round), so
    the wire time is sum_r cap_r * tile_bytes / link_bw — independent of
    D.  Transfers depend only on resident tiles and are
    issued before compute; overlap is capped by the local-B segment's
    compute time.
    """
    config = config or SpadaConfig()
    p = problem
    tile_bytes = p.tk * p.tn * tile_itemsize
    flops_item = 2 * p.tm * p.tk * p.tn
    # per-shard work from the segment-ordered worklists (padded items hit
    # the dump slot but still issue tile products — count them)
    real = p.o_tid != p.nCmax
    w_shard = real.sum(axis=1).astype(np.float64)
    flops = w_shard * flops_item
    hbm = (w_shard * (p.tm * p.tk + p.tk * p.tn) * tile_itemsize
           + p.n_c_tiles.astype(np.float64) * p.tm * p.tn * 4)
    compute_s, imb = _shard_compute_s(flops, hbm, config)

    comm_bytes = int(sum(p.caps)) * tile_bytes  # per device, rounds serial
    comm_s = comm_bytes / MODEL_TARGET.link_bytes_per_s
    # local-B segment compute hides transfers (worklists are local-first)
    local_real = real[:, : p.seg_ptr[1]].sum(axis=1).astype(np.float64)
    local_s, _ = _shard_compute_s(
        local_real * flops_item,
        local_real * (p.tm * p.tk + p.tk * p.tn) * tile_itemsize, config)
    overlap = min(comm_s, local_s)
    total = compute_s + comm_s - overlap
    return ScalingEstimate(
        strategy="halo", n_dev=p.n_dev, compute_s=compute_s, comm_s=comm_s,
        overlap_s=overlap, total_s=total,
        efficiency=compute_s / total if total else 1.0,
        comm_bytes=comm_bytes * p.n_dev, imbalance=imb,
    )


def estimate_reduce_scaling(problem, config: Optional[SpadaConfig] = None,
                            tile_itemsize: int = 2) -> ScalingEstimate:
    """Model the K-sharded psum-merge strategy over NVLink.

    The tp-axis merge is a reduce_scatter (spgemm_sharded's default):
    (tp-1)/tp of each dp panel's C bytes over the links, leaving C
    tile-sharded over tp.  It cannot overlap the local products (it
    consumes their outputs) — the strategy wins only when C is small vs
    the halo.
    """
    config = config or SpadaConfig()
    p = problem
    flops_item = 2 * p.tm * p.tk * p.tn
    w_shard = p.work_per_shard.reshape(-1).astype(np.float64)
    flops = w_shard * flops_item
    hbm = (w_shard * (p.tm * p.tk + p.tk * p.tn) * tile_itemsize
           + np.repeat(p.n_c_tiles.astype(np.float64), p.n_tp)
           * p.tm * p.tn * 4)
    compute_s, imb = _shard_compute_s(flops, hbm, config)

    c_bytes = int(p.n_c_tiles.sum()) * p.tm * p.tn * 4
    per_dev = ((p.n_tp - 1) / max(p.n_tp, 1)) * (c_bytes / max(p.n_dp, 1))
    comm_s = per_dev / MODEL_TARGET.link_bytes_per_s
    total = compute_s + comm_s
    return ScalingEstimate(
        strategy="reduce", n_dev=p.n_dp * p.n_tp, compute_s=compute_s,
        comm_s=comm_s, overlap_s=0.0, total_s=total,
        efficiency=compute_s / total if total else 1.0,
        comm_bytes=int(per_dev * p.n_dp * p.n_tp), imbalance=imb,
    )
