"""Multi-chip execution over a ``jax.sharding.Mesh``.

The reference is single-threaded (SURVEY.md §2.3: zero distributed code), so
this package is new capability, with semantics lifted from the reference's
scheduler decomposition:

- **dp** (data parallel): A's row panels — the block rows the scheduler
  marches over (``next_block``, scheduler.rs:296-379) — are sharded across
  devices; C inherits the sharding.  No communication during multiply.
- **tp** (tensor parallel over K): the contraction dimension is sharded; each
  shard produces partial C tiles and the distributed psum-merge is a
  ``jax.lax.psum`` over the ``tp`` axis — the reference's merge-task graph
  (scheduler.rs:381-480, 820-920) realized as an XLA collective (NCCL over NVLink on GPUs).
- **halo** (dp-only alternative): B stays k-sharded and each device fetches
  the B tiles its worklist needs via a bucketed ``all_to_all`` exchange —
  the "ragged all-to-all" design of SURVEY.md §5.8, made static-shape by
  host-side capacity planning.
- **element dp**: the scattered-structure (ESC) engine distributes by
  E-balanced row slabs with ZERO collectives — the element plan gathers
  every operand host-side, so row ownership is total (element_dp.py).

PP/SP/EP are not meaningful for a single SpGEMM op (documented in
SURVEY.md §2.3).
"""

from spada_tpu.parallel.element_dp import (partition_element,
                                           spgemm_element_dp)
from spada_tpu.parallel.halo import partition_halo, spgemm_halo
from spada_tpu.parallel.partition import (choose_parallel_strategy,
                                          partition_spgemm, ShardedProblem)
from spada_tpu.parallel.spgemm import spgemm_sharded

__all__ = ["partition_spgemm", "ShardedProblem", "spgemm_sharded",
           "partition_halo", "spgemm_halo", "choose_parallel_strategy",
           "partition_element", "spgemm_element_dp"]
