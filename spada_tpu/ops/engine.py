"""Numeric phase: the block-sparse tile-product engines.

Two engines compute C tiles ``[n_c_tiles, tm, tn]`` (f32) from a
:class:`~spada_tpu.ops.worklist.WorkList`:

- :func:`run_worklist_triton` — a Pallas kernel on the Triton route.  The
  grid is (C tile, tm/BM, tn/BN); each program reads its run of work items
  from an int32 run pointer (the ``searchsorted`` of the o-sorted
  ``o_tid``), loads the A and B sub-blocks of every item by tile id,
  accumulates the products in registers with f32 accumulation, and stores
  its C block once.  It needs a row-ordered (o-sorted) worklist.
- :func:`run_worklist_xla` — gather + batched matmul + scatter-add in
  chunks.  Order-independent, so it serves the k-major ``op`` schedule, and
  ``precision='highest'``, where an f32 dot is true f32.

In both, the register/accumulator sum over an output run realizes the
psum-buffer/sorting-network/merge-tree multiply-merge of the reference's
PE pipeline (simulator.rs:117-235) as tile matmul + add.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

ENGINES = ("auto", "xla", "triton")


def select_engine(order: str = "row", precision: str = "default") -> str:
    """Auto engine choice: the Triton-route kernel on a GPU for row-ordered,
    non-HIGHEST worklists; XLA otherwise (k-major schedules need scatter
    accumulation, HIGHEST wants XLA's true-f32 dot, and off the GPU the
    kernel could only run interpreted)."""
    from spada_tpu.platform import on_gpu

    if order == "row" and precision != "highest" and on_gpu():
        return "triton"
    return "xla"


def run_worklist(wl, a_tiles, b_tiles, precision: str = "highest",
                 engine: Optional[str] = None, interpret: bool = False):
    """Dispatch a WorkList to the chosen (default: auto) engine."""
    eng = engine if engine not in (None, "auto") else select_engine(
        wl.order, precision)
    if eng == "triton":
        if wl.order != "row":
            raise ValueError("the triton engine needs a row-ordered worklist")
        return run_worklist_triton(
            a_tiles, b_tiles, wl.a_tid, wl.b_tid, wl.o_tid,
            n_c_tiles=wl.n_c_tiles, precision=precision, interpret=interpret,
        )
    if eng != "xla":
        raise ValueError(f"unknown engine {eng!r}; expected one of {ENGINES}")
    return run_worklist_xla(
        a_tiles, b_tiles, wl.a_tid, wl.b_tid, wl.o_tid,
        n_c_tiles=wl.n_c_tiles, precision=precision,
    )


def _resolve_precision(name: str):
    # 'highest': true f32 products; 'default': bf16 tiles as they are, f32
    # tiles in TF32 on the GPU's tensor cores
    return {
        "highest": jax.lax.Precision.HIGHEST,
        "default": jax.lax.Precision.DEFAULT,
    }[name]


# --------------------------------------------------------------------------
# Portable XLA engine
# --------------------------------------------------------------------------

def accumulate_xla(c, a_ids, b_ids, o_ids, a_tiles, b_tiles, chunk: int,
                   precision):
    """``c`` plus every work item's product, in chunks of gather ->
    batched matmul -> scatter-add (chunks keep the partials bounded).
    Traceable; shared by the single-device and the sharded engines."""
    W = a_ids.shape[0]
    for s in range(-(-W // chunk) if W else 0):
        sl = slice(s * chunk, min((s + 1) * chunk, W))
        part = jax.lax.dot_general(
            a_tiles[a_ids[sl]],
            b_tiles[b_ids[sl]],
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
            precision=precision,
        )
        c = c.at[o_ids[sl]].add(part)
    return c


@functools.partial(jax.jit, static_argnames=("n_c_tiles", "chunk", "precision"))
def _run_xla(a_ids, b_ids, o_ids, a_tiles, b_tiles, n_c_tiles: int,
             chunk: int = 4096, precision: str = "highest"):
    c = jnp.zeros((n_c_tiles, a_tiles.shape[1], b_tiles.shape[2]),
                  jnp.float32)
    return accumulate_xla(c, a_ids, b_ids, o_ids, a_tiles, b_tiles, chunk,
                          _resolve_precision(precision))


def run_worklist_xla(a_tiles, b_tiles, a_ids, b_ids, o_ids, n_c_tiles: int,
                     chunk: int = 4096, precision: str = "highest"):
    """Order-independent engine (scatter-add): works for k-major schedules."""
    if n_c_tiles == 0 or len(a_ids) == 0:
        tm, tn = a_tiles.shape[1], b_tiles.shape[2]
        return jnp.zeros((max(n_c_tiles, 0), tm, tn), jnp.float32)
    return _run_xla(
        jnp.asarray(a_ids), jnp.asarray(b_ids), jnp.asarray(o_ids),
        jnp.asarray(a_tiles), jnp.asarray(b_tiles),
        n_c_tiles=n_c_tiles, chunk=chunk, precision=precision,
    )


# --------------------------------------------------------------------------
# Run-accumulating tile kernel (Pallas, Triton route)
# --------------------------------------------------------------------------

# Block sizes and launch parameters, chosen on an H100 (see PERF.md,
# "Kernel decisions").  Each must be a power of two; pl.dot needs >= 16.
BLOCK_M, BLOCK_N, BLOCK_K = 128, 128, 64
NUM_WARPS, NUM_STAGES = 8, 3
_MIN_DOT = 16


def _block(edge: int, pref: int) -> int:
    """Largest power of two <= ``pref`` dividing ``edge`` (>= 16)."""
    b = pref
    while b > _MIN_DOT and edge % b:
        b //= 2
    return b


def _pad_to(x, axis: int, mult: int):
    pad = (-x.shape[axis]) % mult
    if not pad:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


def _tile_kernel(run_ptr_ref, a_ids_ref, b_ids_ref, a_ref, b_ref, c_ref, *,
                 bm: int, bn: int, bk: int, nk: int, precision):
    from jax.experimental import pallas as pl

    t = pl.program_id(0)
    rows = pl.ds(pl.program_id(1) * bm, bm)
    cols = pl.ds(pl.program_id(2) * bn, bn)
    lo = run_ptr_ref[t]
    hi = run_ptr_ref[t + 1]

    # one flat loop over (item, k block) so the compiler pipelines loads
    # across item boundaries as well as within an item
    def step(s, acc):
        # lax.div/rem: s >= 0, and jnp's floor-division sign fix-ups do not
        # lower on the Triton route
        w = lo + jax.lax.div(s, nk)
        ks = pl.ds(jax.lax.rem(s, nk) * bk, bk)
        a = a_ref[a_ids_ref[w], rows, ks]
        b = b_ref[b_ids_ref[w], ks, cols]
        return acc + pl.dot(a, b, precision=precision)

    acc = jax.lax.fori_loop(0, (hi - lo) * nk, step,
                            jnp.zeros((bm, bn), jnp.float32))
    c_ref[...] = acc


@functools.partial(
    jax.jit,
    static_argnames=("n_c_tiles", "precision", "interpret", "bm", "bn", "bk",
                     "num_warps", "num_stages"),
)
def _run_triton(run_ptr, a_ids, b_ids, a_tiles, b_tiles, n_c_tiles: int,
                precision: str = "default", interpret: bool = False,
                bm: int = BLOCK_M, bn: int = BLOCK_N, bk: int = BLOCK_K,
                num_warps: int = NUM_WARPS, num_stages: int = NUM_STAGES):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    tm, tn = a_tiles.shape[1], b_tiles.shape[2]
    # panel heights and tile edges that no block divides are zero-padded
    # (exact: padded rows/cols of A and B contribute nothing)
    bm = _block(max(tm, _MIN_DOT), bm)
    bn = _block(max(tn, _MIN_DOT), bn)
    bk = _block(max(a_tiles.shape[2], _MIN_DOT), bk)
    a_p = _pad_to(_pad_to(a_tiles, 1, bm), 2, bk)
    b_p = _pad_to(_pad_to(b_tiles, 1, bk), 2, bn)
    tmp, tkp, tnp = a_p.shape[1], a_p.shape[2], b_p.shape[2]
    kernel = functools.partial(
        _tile_kernel, bm=bm, bn=bn, bk=bk, nk=tkp // bk,
        precision=_resolve_precision(precision))
    whole = pl.BlockSpec(memory_space=None)
    c = pl.pallas_call(
        kernel,
        grid=(n_c_tiles, tmp // bm, tnp // bn),
        in_specs=[whole] * 5,
        out_specs=pl.BlockSpec((None, bm, bn), lambda t, i, j: (t, i, j)),
        out_shape=jax.ShapeDtypeStruct((n_c_tiles, tmp, tnp), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        backend="triton",
        interpret=interpret,
        name="spada_tile_runs",
    )(run_ptr, a_ids, b_ids, a_p, b_p)
    if (tmp, tnp) != (tm, tn):
        c = c[:, :tm, :tn]
    return c


def run_pointer(o_ids, n_c_tiles: int) -> np.ndarray:
    """int32 [n_c_tiles + 1]: items of C tile t are
    ``[ptr[t], ptr[t + 1])`` of an o-sorted worklist."""
    o = np.asarray(o_ids)
    if len(o) > 1 and np.any(o[1:] < o[:-1]):
        raise ValueError("run pointer needs an o-sorted (row-ordered) "
                         "worklist")
    return np.searchsorted(o, np.arange(n_c_tiles + 1)).astype(np.int32)


def run_worklist_triton(a_tiles, b_tiles, a_ids, b_ids, o_ids,
                        n_c_tiles: int, precision: str = "default",
                        interpret: bool = False, **blocks):
    """Run-accumulating kernel engine for a row-ordered worklist.

    Accumulation is f32.  bf16 tiles carry bf16 input rounding (relative
    error of C about 2e-3 on the nn operands, limit 2e-2); f32 tiles at
    ``precision='default'`` run their dots in TF32 on the GPU (10-bit
    mantissa), held to the same 2e-2 limit — ``'highest'`` goes to XLA for
    f32-exact results.  ``blocks`` may override ``bm``, ``bn``, ``bk``,
    ``num_warps`` and ``num_stages``.  ``interpret=True`` runs the kernel
    on the CPU (tests).
    """
    if n_c_tiles == 0 or len(a_ids) == 0:
        tm, tn = a_tiles.shape[1], b_tiles.shape[2]
        return jnp.zeros((max(n_c_tiles, 0), tm, tn), jnp.float32)
    return _run_triton(
        jnp.asarray(run_pointer(o_ids, n_c_tiles)),
        jnp.asarray(np.asarray(a_ids, np.int32)),
        jnp.asarray(np.asarray(b_ids, np.int32)),
        jnp.asarray(a_tiles), jnp.asarray(b_tiles),
        n_c_tiles=n_c_tiles, precision=precision, interpret=interpret,
        **blocks,
    )
