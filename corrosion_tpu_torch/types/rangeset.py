"""Inclusive integer range sets with adjacency coalescing.

Behavioral counterpart of `rangemap::RangeInclusiveSet<u64>` as used across
the reference for version-gap and seq-gap bookkeeping (`klukai-types/src/
agent.rs:1068-1246`, `sync.rs:126-248`). Ranges are closed [start, end];
inserting [1,2] then [3,4] coalesces to [1,4] (integer adjacency), exactly
like rangemap with StepLite — the sync set-algebra depends on this.

The port's copy of `corrosion_tpu/types/rangeset.py`.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Iterable, Iterator, List, Optional, Tuple

Range = Tuple[int, int]


class RangeSet:
    """Sorted, disjoint, coalesced list of inclusive [start, end] ranges."""

    __slots__ = ("_starts", "_ends")

    def __init__(self, ranges: Optional[Iterable[Range]] = None):
        self._starts: List[int] = []
        self._ends: List[int] = []
        if ranges:
            for s, e in ranges:
                self.insert(s, e)

    # -- core ops ---------------------------------------------------------

    def insert(self, start: int, end: int) -> None:
        if end < start:
            return
        # find all ranges overlapping or adjacent to [start-1, end+1]
        i = bisect_left(self._ends, start - 1)
        j = bisect_right(self._starts, end + 1)
        if i < j:  # merge with [i, j)
            start = min(start, self._starts[i])
            end = max(end, self._ends[j - 1])
        del self._starts[i:j]
        del self._ends[i:j]
        self._starts.insert(i, start)
        self._ends.insert(i, end)

    def remove(self, start: int, end: int) -> None:
        if end < start:
            return
        i = bisect_left(self._ends, start)
        j = bisect_right(self._starts, end)
        if i >= j:
            return
        left_keep = None
        right_keep = None
        if self._starts[i] < start:
            left_keep = (self._starts[i], start - 1)
        if self._ends[j - 1] > end:
            right_keep = (end + 1, self._ends[j - 1])
        del self._starts[i:j]
        del self._ends[i:j]
        if right_keep:
            self._starts.insert(i, right_keep[0])
            self._ends.insert(i, right_keep[1])
        if left_keep:
            self._starts.insert(i, left_keep[0])
            self._ends.insert(i, left_keep[1])

    def contains(self, v: int) -> bool:
        i = bisect_right(self._starts, v) - 1
        return i >= 0 and self._ends[i] >= v

    def contains_range(self, start: int, end: int) -> bool:
        i = bisect_right(self._starts, start) - 1
        return i >= 0 and self._starts[i] <= start and self._ends[i] >= end

    def overlapping(self, start: int, end: int) -> Iterator[Range]:
        """Yield stored ranges intersecting [start, end] (uncropped, like
        rangemap's overlapping())."""
        i = bisect_left(self._ends, start)
        while i < len(self._starts) and self._starts[i] <= end:
            yield (self._starts[i], self._ends[i])
            i += 1

    def gaps(self, start: int, end: int) -> Iterator[Range]:
        """Yield maximal sub-ranges of [start, end] not covered by the set."""
        cur = start
        for s, e in self.overlapping(start, end):
            if s > cur:
                yield (cur, min(s - 1, end))
            cur = max(cur, e + 1)
            if cur > end:
                break
        if cur <= end:
            yield (cur, end)

    # -- conveniences -----------------------------------------------------

    def __iter__(self) -> Iterator[Range]:
        return iter(zip(self._starts, self._ends))

    def __len__(self) -> int:
        return len(self._starts)

    def __bool__(self) -> bool:
        return bool(self._starts)

    def __eq__(self, other) -> bool:
        return isinstance(other, RangeSet) and list(self) == list(other)

    def __repr__(self) -> str:
        return f"RangeSet({list(self)})"

    def is_empty(self) -> bool:
        return not self._starts

    def count_values(self) -> int:
        return sum(e - s + 1 for s, e in self)

    def min(self) -> Optional[int]:
        return self._starts[0] if self._starts else None

    def max(self) -> Optional[int]:
        return self._ends[-1] if self._ends else None

    def copy(self) -> "RangeSet":
        rs = RangeSet()
        rs._starts = list(self._starts)
        rs._ends = list(self._ends)
        return rs

    def union(self, other: "RangeSet") -> "RangeSet":
        rs = self.copy()
        for s, e in other:
            rs.insert(s, e)
        return rs

    def difference(self, other: "RangeSet") -> "RangeSet":
        rs = self.copy()
        for s, e in other:
            rs.remove(s, e)
        return rs
