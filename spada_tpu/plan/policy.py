"""Sequential adaptive block-shape policies.

Functional replicas of the reference's four adjustment schemes, operating on
abstract cost/latency feedback so they are testable as pure logic (SURVEY.md
§4 "policy tests").  The batch planner (:mod:`spada_tpu.plan.planner`) uses
the same decision rules but evaluates candidates analytically in one pass;
these classes preserve the *online* sample-then-commit behavior for parity
and for profile-guided planning on hardware.

Scheme map (``adjust_scheme``, scheduler.rs:203 & 675-700):
  0. :class:`RowwiseCostPolicy`    — rowwise_adjust.rs:125-280
  1. :class:`ColwiseRegPolicy`     — colwise_reg_adjust.rs:37-109
  2. :class:`ColwiseIrrPolicy`     — colwise_irr_adjust.rs:47-110
  3. :class:`RowwiseLatencyPolicy` — rowwise_perf_adjust.rs:121-231 (default)

Heights are abstract "row numbers": powers of two from 1 to ``lane_num`` in
the reference; the planner instantiates them with tile panel heights
(8..128).  Cost metric (rowwise_adjust.rs:227-234):
``(dram_miss + psum_dram_writes) * miss_weight + cache_rw``.

Known upstream quirk, deliberately not reproduced: the narrow-group branch of
scheme 3 divides both candidate latencies by the *current* height's element
count (rowwise_perf_adjust.rs:204-207); here each is normalized by its own
element count, which is the evident intent.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List

import numpy as np

from spada_tpu.plan.groups import GroupTracker, parse_group
from spada_tpu.plan.topo import BlockTopoTracker

UNSET = -1


@dataclasses.dataclass
class BlockFeedback:
    """Per-block execution feedback (the reference's ``*BlockInfo`` structs)."""

    a_ele_num: int = 0
    cost: int = 0          # scheme 0/1/2: weighted traffic; scheme 3: latency


def _shrink_to_fit(height: int, row_s: int, group_end: int) -> int:
    """Halve until the block fits inside the group (rowwise_adjust.rs:203-207)."""
    while height > 1 and row_s + height >= group_end:
        height //= 2
    return height


class _RowwiseBase:
    def __init__(self, lane_num: int, a_row_lens, b_row_lens, var_factor: float = 1.5,
                 group_diviser: int = 128, sample_num: int = 4):
        self.lane_num = lane_num
        self.a_group: GroupTracker = parse_group(np.asarray(a_row_lens), var_factor)
        self.b_group: GroupTracker = parse_group(np.asarray(b_row_lens), var_factor)
        self.group_diviser = group_diviser
        self.sample_num = sample_num
        self.row_group = UNSET
        self.sampling_bounds: List[int] = []
        self.set_row_num = UNSET
        self.block_info: Dict[int, BlockFeedback] = {}

    # -- shared skeleton --
    def _enter_group(self, row_s: int) -> None:
        self.row_group = self.a_group.group_of(row_s)
        gi = self.a_group.groups[self.row_group]
        if gi.row_range[1] - gi.row_range[0] > self.group_diviser:
            # sampling schedule: sample_num blocks at each height 1,2,4,...
            cur_row = row_s + 1
            self.sampling_bounds = []
            h = 1
            while h <= self.lane_num:
                cur_row += self.sample_num * h
                self.sampling_bounds.append(cur_row)
                h *= 2
        self.set_row_num = UNSET

    def _is_wide(self) -> bool:
        gi = self.a_group.groups[self.row_group]
        return gi.row_range[1] - gi.row_range[0] > self.group_diviser

    def _sampling_height(self, row_s: int) -> int:
        """Height for the sampling phase: 2^(position among bounds)."""
        i = bisect.bisect_left(self.sampling_bounds, row_s)
        if i < len(self.sampling_bounds) and self.sampling_bounds[i] == row_s:
            return 2 ** (i + 1)
        return 2 ** i

    def _commit_height(self, feedback: Dict[int, list]) -> int:
        """Argmin of accumulated cost/element over sampled heights; if some
        height was never sampled, try it next (exploration)."""
        best, best_val = UNSET, float("inf")
        h = 1
        while h <= self.lane_num:
            if h in feedback:
                num, den = feedback[h]
                v = num / (den + 1e-4)
                if v < best_val:
                    best_val, best = v, h
            else:
                feedback[h] = [0, 0]
                return h
            h *= 2
        return best

    def update_group_cost(self, token: int, anchor_row: int, height: int,
                          a_ele_num: int) -> None:
        """Fold a finished block's feedback into its group's table
        (rowwise_adjust.rs:260-276)."""
        gi = self.a_group.groups[self.a_group.group_of(anchor_row)]
        fb = self.block_info[token]
        entry = gi.cost_num.setdefault(height, [0, 0])
        entry[0] += fb.cost
        entry[1] += a_ele_num


class RowwiseCostPolicy(_RowwiseBase):
    """Scheme 0: wide groups sample-then-commit on weighted traffic cost;
    narrow groups hill-climb against the two blocks above."""

    def adjust_block_shape(self, prev_anchor_row: int, prev_anchor_col: int,
                           row_s: int, height: int,
                           topo: BlockTopoTracker, a_row_lens) -> int:
        if self.a_group.group_of(row_s) != self.row_group:
            self._enter_group(row_s)
            return 1
        gi = self.a_group.groups[self.row_group]
        if self._is_wide():
            if row_s >= self.sampling_bounds[-1]:
                if self.set_row_num == UNSET:
                    self.set_row_num = self._commit_height(gi.cost_num)
                h = self.set_row_num
            else:
                h = self._sampling_height(row_s)
            return _shrink_to_fit(h, row_s, gi.row_range[1])
        # narrow group: compare the two blocks above (rowwise_adjust.rs:209-255)
        n1 = topo.find_above(prev_anchor_row, prev_anchor_col)
        if n1 is None:
            return height
        n1_token, n1_row, _ = n1
        n1_rows = prev_anchor_row - n1_row
        n1_ele = int(np.sum(a_row_lens[n1_row:prev_anchor_row]))
        n2 = topo.find_above(n1_row, prev_anchor_col)
        if n2 is None:
            return height
        n2_token, n2_row, _ = n2
        n2_rows = n1_row - n2_row
        n2_ele = int(np.sum(a_row_lens[n2_row:n1_row]))
        n1_cost = self.block_info[n1_token].cost
        n2_cost = self.block_info[n2_token].cost
        better_recent = (n1_cost / max(n1_ele, 1)) <= (n2_cost / max(n2_ele, 1))
        grew = n1_rows >= n2_rows
        if better_recent == grew:
            height = min(height * 2, self.lane_num)
        else:
            height = max(height // 2, 1)
        return _shrink_to_fit(height, row_s, gi.row_range[1])


class RowwiseLatencyPolicy(_RowwiseBase):
    """Scheme 3 (default): same skeleton, but the feedback is measured block
    latency — the profile-guided signal (simulator.rs:589-603)."""

    def adjust_block_shape(self, row_s: int, height: int) -> int:
        gi_ok = (
            self.row_group != UNSET
            and self.a_group.group_of(row_s) == self.row_group
            and height in self.a_group.groups[self.row_group].cost_num
        )
        if not gi_ok:
            self._enter_group(row_s)
            return 1
        gi = self.a_group.groups[self.row_group]
        if self._is_wide():
            if row_s >= self.sampling_bounds[-1]:
                if self.set_row_num == UNSET:
                    self.set_row_num = self._commit_height(gi.cost_num)
                h = self.set_row_num
            else:
                h = self._sampling_height(row_s)
        else:
            # narrow group: grow while the doubled height keeps improving
            cur = gi.cost_num.get(height)
            half = gi.cost_num.get(height // 2)
            if self.set_row_num == UNSET and (
                half is None or (cur[0] / (cur[1] + 1e-4)) < (half[0] / (half[1] + 1e-4))
            ):
                h = height * 2
            else:
                best, best_val = UNSET, float("inf")
                for hh, (num, den) in gi.cost_num.items():
                    v = num / (den + 1e-4)
                    if v < best_val:
                        best_val, best = v, hh
                self.set_row_num = best
                h = best
        return _shrink_to_fit(h, row_s, gi.row_range[1])


class ColwiseRegPolicy:
    """Scheme 1: fixed (8 x 8) blocks; the *window height* hill-climbs against
    the two blocks to the left (colwise_reg_adjust.rs:37-109)."""

    def __init__(self, lane_num: int, block_width: int = 8):
        self.lane_num = lane_num
        self.block_width = block_width
        self.block_info: Dict[int, BlockFeedback] = {}
        self.window_shape: Dict[int, tuple] = {}

    def adjust_block_shape(self, row_s: int, a_row_num: int) -> tuple:
        h = self.block_width
        while row_s + h > a_row_num and h > 1:
            h //= 2
        return (h, self.block_width)

    def adjust_window_shape(self, token: int, anchor_row: int, anchor_col: int,
                            block_height: int, topo: BlockTopoTracker) -> tuple:
        def clamp(win_h: int) -> tuple:
            while win_h > block_height:
                win_h = max(1, win_h // 2)
            shape = (win_h, self.lane_num // win_h)
            self.window_shape[token] = shape
            return shape

        n1 = topo.find_left(anchor_row, anchor_col)
        if n1 is None:
            return clamp(self.lane_num)
        n1_token = n1[0]
        n2 = topo.find_left(n1[1], n1[2])
        if n2 is None:
            return clamp(self.lane_num // 2)
        n2_token = n2[0]
        f1, f2 = self.block_info[n1_token], self.block_info[n2_token]
        c1 = f1.cost / max(f1.a_ele_num, 1)
        c2 = f2.cost / max(f2.a_ele_num, 1)
        h1 = self.window_shape[n1_token][0]
        h2 = self.window_shape[n2_token][0]
        if (c1 <= c2) == (h1 >= h2):
            return clamp(min(self.lane_num, h1 * 2))
        return clamp(max(1, h1 // 2))


class ColwiseIrrPolicy:
    """Scheme 2: block height adjusted only at group boundaries, degrade-only
    (colwise_irr_adjust.rs:47-110)."""

    def __init__(self, lane_num: int, group_size: int, block_width: int):
        self.lane_num = lane_num
        self.group_size = group_size
        self.block_width = block_width
        self.block_info: Dict[int, BlockFeedback] = {}
        self.block_shape: Dict[tuple, tuple] = {}
        self.group_shape: Dict[int, tuple] = {}

    def adjust_block_shape(self, anchor_row: int, anchor_col: int,
                           a_row_num: int, topo: BlockTopoTracker) -> tuple:
        if anchor_row % self.group_size != 0:
            return self.group_shape[anchor_row // self.group_size]

        def commit(h: int) -> tuple:
            while anchor_row + h > a_row_num and h > 1:
                h //= 2
            shape = (h, self.block_width)
            self.block_shape[(anchor_row, anchor_col)] = shape
            self.group_shape[anchor_row // self.group_size] = shape
            return shape

        n1 = topo.find_left(anchor_row, anchor_col)
        if n1 is None:
            return commit(self.lane_num)
        n1_token, n1_row, n1_col = n1
        n2 = topo.find_left(n1_row, n1_col)
        if n2 is None:
            return commit(self.lane_num // 2)
        n2_token = n2[0]
        f1, f2 = self.block_info[n1_token], self.block_info[n2_token]
        c1 = f1.cost / max(f1.a_ele_num, 1)
        c2 = f2.cost / max(f2.a_ele_num, 1)
        h1 = self.block_shape[(n1_row, n1_col)][0]
        if c1 < c2:
            return commit(max(1, h1 // 2))
        return commit(h1)


def traffic_cost(dram_miss: int, psum_dram_writes: int, cache_rw: int,
                 miss_weight: int = 100) -> int:
    """The reference cost metric (rowwise_adjust.rs:227-234)."""
    return (dram_miss + psum_dram_writes) * miss_weight + cache_rw
