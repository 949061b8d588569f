"""Device timing of a jitted computation.

:func:`device_time` runs ``K`` executions *chained inside one jitted
fori_loop* and fences with ``block_until_ready``.  The per-execution time
is the two-point slope ``(t(4K) - t(K)) / 3K``, which cancels the constant
dispatch and fence cost of the launch.  The loop-carry rules below keep XLA
from hoisting or eliding the work being timed.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Sequence

import numpy as np


def device_time_stats(
    fn: Callable,
    args: Sequence,
    k: int = 8,
    trials: int = 3,
):
    """(median seconds, slope samples) per execution of ``fn(*args)``.

    ``fn(*args) -> array or pytree``; do NOT perturb operands inside ``fn``
    — the harness owns the loop-carry dependency (below).  The median over
    ``trials`` of the two-point slope rejects spikes in either direction
    (a min over slope samples could go negative under jitter); the raw
    samples quantify the spread.

    Loop-carry discipline (each rule removes a measured artifact):

    * The FULL output pytree is the fori_loop carry.  A scalar
      ``sum(out)`` carry is not enough: XLA fuses the reduction into an
      elementwise producer and never stores the output, so a pure
      ``a*b`` would time as a read-only stream.  Carried leaves must be
      materialized every iteration, so output HBM writes are timed like
      the real dispatch pays them.
    * EVERY float input is ALSO carried, perturbed by one in-place
      element add per iteration (``a.at[0,...].add(eps)`` on a linearly
      used loop carry compiles to an in-place scatter).  Perturbing only
      the first arg lets XLA hoist every computation not reachable from
      it out of the loop; perturbing via a full-array ``a + eps`` cannot
      fuse into a Pallas custom call and would charge the tile kernel a
      whole phantom HBM pass over its operands.  Integer args (run
      pointers, index maps) pass through untouched: every device
      computation reads at least one float operand, which is enough loop
      dependence.
    """
    import jax
    import jax.numpy as jnp

    # the loop-carry discipline below assumes at least one FLOAT operand
    # threads the iterations together; with none, fn's inputs are
    # loop-invariant and XLA hoists the whole computation out of the loop —
    # the harness would silently "measure" near-zero
    if not any(hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.inexact)
               and getattr(a, "size", 0) for a in args):
        raise ValueError(
            "device_time_stats needs at least one non-empty float operand "
            "in args to carry the loop dependency; an all-integer "
            "signature would be hoisted out of the timing loop and "
            "measure nothing")

    def _probe(out):
        # one element per leaf: cheap, but keeps every carried leaf live
        # (XLA's while-loop simplifier removes only fully-dead carry slots)
        leaves = jax.tree_util.tree_leaves(out)
        acc = jnp.float32(0.0)
        for leaf in leaves:
            if leaf.size:
                acc = acc + jnp.sum(
                    leaf.reshape(-1)[:1]).astype(jnp.float32)
        return acc

    @functools.partial(jax.jit, static_argnames="K")
    def runK(*fargs, K=k):
        out_shape = jax.eval_shape(fn, *fargs)
        init = jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), out_shape)
        perturb = [i for i, a in enumerate(fargs)
                   if hasattr(a, "dtype")
                   and jnp.issubdtype(a.dtype, jnp.inexact) and a.size]

        def body(i, carry):
            s, fa, prev = carry
            # cast per leaf — adding a strong-f32 scalar would silently
            # promote bf16 inputs to f32 and change what is being measured
            eps = (s + _probe(prev)) * 1e-30
            fa = tuple(a.at[(0,) * a.ndim].add(eps.astype(a.dtype))
                       for a in fa)
            full = list(fargs)
            for j, i_arg in enumerate(perturb):
                full[i_arg] = fa[j]
            out = fn(*full)
            return (_probe(out) * 1e-30, fa, out)

        init_fa = tuple(fargs[i] for i in perturb)
        s, _, out = jax.lax.fori_loop(0, K, body,
                                      (jnp.float32(0.0), init_fa, init))
        return s + _probe(out) * 1e-30

    def run_once(kk):
        t0 = time.perf_counter()
        jax.block_until_ready(runK(*args, K=kk))
        return time.perf_counter() - t0

    # two-point slope: per-iter = (t(4K) - t(K)) / 3K; subtracting the two
    # totals cancels the launch's constant cost.  Compile both K first.
    run_once(k)
    run_once(4 * k)
    samples = []
    for _ in range(trials):
        t1 = run_once(k)
        t4 = run_once(4 * k)
        samples.append((t4 - t1) / (3 * k))
    return max(float(np.median(samples)), 1e-9), samples


def device_time(
    fn: Callable,
    args: Sequence,
    k: int = 8,
    trials: int = 3,
) -> float:
    """Seconds per execution of ``fn(*args) -> array`` (median of slopes).

    See :func:`device_time_stats` for the measurement contract; this is the
    median-only convenience used throughout the engines."""
    return device_time_stats(fn, args, k=k, trials=trials)[0]
