"""spada_tpu — a sparse linear-algebra framework on JAX, run on an NVIDIA GPU.

Re-realizes the capabilities of ``tsinghua-ideal/spada-sim`` (the cycle-level
simulator for *Spada: Accelerating Sparse Matrix Multiplication with Adaptive
Dataflow*, ASPLOS 2023) as real kernels on a real accelerator:

- CSR/MatrixMarket/pickled-GEMM ingestion (reference: ``py2rust.rs``,
  ``gemm.rs``, ``preprocessing.rs``)
- adaptive-dataflow SpGEMM — per-row-panel block-shape + dataflow selection
  (reference: ``scheduler.rs``, ``rowwise_adjust.rs``, ``rowwise_perf_adjust.rs``,
  ``colwise_reg_adjust.rs``, ``colwise_irr_adjust.rs``)
- a multiply-merge datapath as block-sparse tile matmuls plus an
  element-granular expand-sort-compress path (reference: ``simulator.rs`` PE pipeline, ``adder_tree.rs``)
- HBM traffic accounting and a functional traffic model (reference:
  ``storage.rs`` counters, ``storage_traffic_model.rs``)
- multi-chip scaling over a ``jax.sharding.Mesh`` (new capability; the
  reference is single-threaded).

This is not a port: the simulator's simulated structures map onto real
mechanisms (mem latency/bandwidth model -> HBM; PE lanes / sorting network /
merge tree -> tile products accumulated in registers + segmented sums;
cycle-by-cycle adaptive scheduling -> host-side cost-guided planning).
"""

__version__ = "0.1.0"

from spada_tpu.config import SpadaConfig
from spada_tpu.sparse.csr import CsrMatrix
from spada_tpu.io.workloads import GemmWorkload

__all__ = [
    "SpadaConfig",
    "CsrMatrix",
    "GemmWorkload",
    "__version__",
]
