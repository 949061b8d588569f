"""Typed configuration for the whole framework.

The reference scatters its tuning surface across a JSON file
(``frontend.rs:8-23``, ``config/config_1mb_row1.json``) and hard-coded
constants (``simulator.rs:449-455``, ``scheduler.rs:203``,
``rowwise_perf_adjust.rs:125-126``, ``rowwise_adjust.rs:227-234``,
``colwise_reg_adjust.rs:39``).  Here every one of those knobs is surfaced in a
single dataclass, together with the execution tunables that replace the
simulated micro-architecture.  Peak rates of the devices live in
:mod:`spada_tpu.platform`, not here.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass
class SpadaConfig:
    # ---- workload locations (reference: OmegaConfig, frontend.rs:8-23) ----
    ss_filepath: str = "./matrices"
    nn_filepath: str = "./matrices/nn_gemm.pkl"

    # ---- simulated-machine knobs, kept for the traffic/functional model ----
    # (reference: config_1mb_row1.json + simulator.rs:449-455)
    pe_num: int = 2
    at_num: int = 16
    lane_num: int = 8
    cache_size: int = 1_572_864          # fiber-cache bytes (1.5 MiB)
    word_byte: int = 8
    block_shape: Tuple[int, int] = (1, 10_000_000)
    mem_latency: int = 30                # cycles
    cache_latency: int = 0               # cycles
    freq: float = 1.0                    # GHz
    channel: int = 16
    bandwidth_per_channel: float = 8.0   # bytes/cycle
    # hard-wired datapath params (simulator.rs:449-455)
    sb_size: int = 4                     # stream-buffer depth
    pb_size: int = 8                     # psum-buffer depth
    pop_num_per_lane: int = 2
    sn_latency: int = 4                  # sorting-network latency
    mt_latency: int = 4                  # merge-tree latency
    tree_width: int = 8                  # adder-tree width

    # ---- adaptive-policy knobs ----
    # (reference: scheduler.rs:203, rowwise_*_adjust.rs, colwise_*_adjust.rs)
    adjust_scheme: int = 3               # 0 cost / 1 colwise-reg / 2 colwise-irr / 3 latency
    var_factor: float = 1.5              # row-group segmentation threshold
    group_diviser: int = 128             # wide-vs-narrow group split
    sample_num: int = 4                  # blocks sampled per candidate height
    cost_miss_weight: int = 100          # DRAM-traffic weight in the cost metric
    colwise_block_width: int = 8         # scheme-1 fixed block width

    # ---- execution knobs (new; replace the simulated uarch) ----
    tile_n: int = 128                    # output-tile width
    tile_k: int = 128                    # contraction-tile depth
    tm_choices: Tuple[int, ...] = (8, 16, 32, 64, 128)  # candidate row-panel heights
    default_tm: int = 128
    dataflow: str = "spada"              # 'spada' | 'ip' | 'op' | 'rowwise'
    engine: str = "auto"                 # 'auto' | 'xla' | 'triton'
    engine_dtype: str = "float32"        # tile dtype: 'float32' | 'bfloat16'
    precision: str = "highest"           # 'highest' (true f32) | 'default' (bf16/TF32)
    acc_dtype: str = "float32"
    # memory budget for densifying C in the outer-product path (bytes)
    dense_c_budget: int = 2 << 30
    # element-granular (ESC) path: chunk cap and dispatch policy
    # ('auto' = byte/overhead cost model picks tile vs element per matrix;
    #  'never'/'always' force one side — the reference's dataflow adaptivity
    #  lifted to the density axis)
    element_cap: int = 512
    element_dispatch: str = "auto"
    # plan-time layout densification inside spgemm() (C-invariant subset:
    # k-grid anchor + k permutation; row permutations need the caller to
    # carry an inverse, so they only apply via preprocess_densified/CLI)
    densify: str = "auto"                # 'auto' | 'off'

    # time model of the tile kernel, used by every tile cost model:
    #   t = max(bytes / BW, flops / (engine_flops_share * peak))
    #       + engine_c_elem_s * (C tiles * tm * tn)
    # with BW and peak the modelled target's (platform.MODEL_TARGET).
    # Least-squares fit to the kernel's times at T = 128..512 on the nn
    # and banded operands, on an NVIDIA H100 80GB HBM3 at a 400 W power
    # limit (PERF.md, "Kernel decisions"): the kernel runs at ~0.40 of the
    # published bf16 peak, and each C-tile element costs ~4.8 ps of
    # per-program set-up and store.
    engine_flops_share: float = 0.40
    engine_c_elem_s: float = 4.8e-12
    # the element executor's measured share of the modelled HBM rate:
    # XLA's fused multiply + row sum streamed stencil7 (1.04 GB) at 0.49
    # of 3.35 TB/s on the same card (PERF.md, "Kernel decisions")
    element_bw_share: float = 0.49

    @classmethod
    def fast(cls, **overrides) -> "SpadaConfig":
        """Throughput profile: bf16 tiles with f32 accumulation, adaptive
        tile size.  Accuracy: ~bf16 input rounding (values within ~0.5% of
        f32); use the default profile for the scipy-exact f32 path."""
        cfg = cls(engine_dtype="bfloat16", precision="default", **overrides)
        return cfg

    @classmethod
    def from_json(cls, path: str) -> "SpadaConfig":
        """Load a config JSON.

        Accepts both this framework's full schema and the reference's flat
        schema (``parse_config``, frontend.rs:77-85) — unknown keys are
        rejected, missing keys take defaults.
        """
        with open(path) as f:
            raw = json.load(f)
        field_names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - field_names
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        if "block_shape" in raw:
            raw["block_shape"] = tuple(raw["block_shape"])
        if "tm_choices" in raw:
            raw["tm_choices"] = tuple(raw["tm_choices"])
        return cls(**raw)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    # ---- derived quantities ----
    @property
    def bandwidth_bytes_per_cycle(self) -> float:
        return self.channel * self.bandwidth_per_channel

    @property
    def cache_words(self) -> int:
        """Fiber-cache capacity in words (``capability``, storage.rs:498)."""
        return self.cache_size // self.word_byte
