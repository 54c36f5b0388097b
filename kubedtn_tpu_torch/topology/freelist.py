"""FreeStack — the engine's columnar row free list.

The historical allocator was a Python ``list[int]`` stack: initialized
``list(range(capacity-1, -1, -1))`` so consecutive pops hand out
consecutive rows, appended on free, REBUILT with ``list(range(...))``
on every ``_ensure_capacity`` growth and ``compact()``, and filtered
element-by-element (``[r for r in free if r not in taken]``) by the
tenant-block carve and the rollback reclaim. Every one of those
rebuilds/filters is an O(capacity) *Python-level* walk under the
engine lock — invisible at 1k rows, a multi-hundred-millisecond
runner pause at the roadmap's million-edge scale, and exactly the
class of host cost the dtnscale layer (`analysis/scale`) budgets.

This class keeps the SAME stack semantics — byte-identical pop order,
pinned against the historical list model by
``tests/test_columnar_allocator.py`` — on one int32 numpy buffer:

- ``pop``/``push`` are O(1) scalar ops on the top pointer;
- growth (``prepend_range``) and compact's rebuild (``from_range``)
  are single vectorized ``np.arange`` writes;
- the tenant-block carve and the rollback reclaim use ``remove_rows``
  — ONE vectorized ``np.isin`` mask, order-preserving like the
  historical comprehension;
- ``pick_pair_rows``' colocation scan reads a bounded ``top_view``
  window and pops by index with a ≤ ``scan_limit`` memmove.

Stack layout: ``_buf[:_n]`` holds live entries bottom→top; pops come
off ``_buf[_n-1]``. The descending initialization puts row 0 on top.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

__all__ = ["FreeStack"]

_DTYPE = np.int32


class FreeStack:
    """Columnar LIFO free list (see module docstring)."""

    __slots__ = ("_buf", "_n")

    def __init__(self, rows: Iterable[int] = ()) -> None:
        arr = np.asarray(list(rows) if not isinstance(rows, np.ndarray)
                         else rows, _DTYPE)
        self._buf = np.array(arr, _DTYPE)  # owned copy
        self._n = int(self._buf.shape[0])

    # -- constructors --------------------------------------------------

    @classmethod
    def from_range(cls, lo: int, hi: int) -> "FreeStack":
        """Rows [lo, hi) as a descending stack — pops yield lo first
        (the historical ``list(range(hi-1, lo-1, -1))``), built as one
        vectorized ``np.arange``."""
        s = cls.__new__(cls)
        s._buf = np.arange(hi - 1, lo - 1, -1, dtype=_DTYPE)
        s._n = int(s._buf.shape[0])
        return s

    # -- core stack ops ------------------------------------------------

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def __contains__(self, row: int) -> bool:
        # test/diagnostic surface only — the allocator never membership-
        # scans its own free list (that is the `scost` linear-scan
        # class this structure exists to kill)
        return bool(np.any(self._buf[:self._n] == row))

    def __iter__(self) -> Iterator[int]:
        return iter(self._buf[:self._n].tolist())

    def view(self) -> np.ndarray:
        """Read-only view of the live entries, bottom→top."""
        v = self._buf[:self._n]
        v.flags.writeable = False
        return v

    def top_view(self, k: int) -> np.ndarray:
        """Read-only view of (at most) the top `k` entries, in stack
        order bottom→top — the colocation scan window."""
        v = self._buf[max(0, self._n - k):self._n]
        v.flags.writeable = False
        return v

    def peek(self) -> int:
        if not self._n:
            raise IndexError("peek from empty FreeStack")
        return int(self._buf[self._n - 1])

    def pop(self) -> int:
        if not self._n:
            raise IndexError("pop from empty FreeStack")
        self._n -= 1
        return int(self._buf[self._n])

    def pop_at(self, i: int) -> int:
        """Remove and return the entry at absolute index `i` (bottom-
        based, like ``list.pop(i)``). The callers (the colocation
        scan) only reach into the top ``scan_limit`` entries, so the
        shift is a bounded memmove."""
        if not 0 <= i < self._n:
            raise IndexError(i)
        row = int(self._buf[i])
        self._buf[i:self._n - 1] = self._buf[i + 1:self._n]
        self._n -= 1
        return row

    def _reserve(self, extra: int) -> None:
        need = self._n + extra
        cap = self._buf.shape[0]
        if need <= cap:
            return
        new = np.empty((max(need, cap * 2, 8),), _DTYPE)
        new[:self._n] = self._buf[:self._n]
        self._buf = new

    def push(self, row: int) -> None:
        self._reserve(1)
        self._buf[self._n] = row
        self._n += 1

    append = push  # list-compatible spelling

    def extend(self, rows) -> None:
        """Vectorized bulk push (stack order = iteration order, so the
        LAST element lands on top, like ``list.extend``)."""
        arr = np.asarray(rows if isinstance(rows, np.ndarray)
                         else list(rows), _DTYPE)
        self._reserve(arr.shape[0])
        self._buf[self._n:self._n + arr.shape[0]] = arr
        self._n += int(arr.shape[0])

    def prepend_range(self, lo: int, hi: int) -> None:
        """Capacity growth: rows [lo, hi) slide UNDER the existing
        entries (descending, so within the new block lo pops first) —
        the historical ``list(range(hi-1, lo-1, -1)) + free``, as one
        arange + one copy instead of an O(capacity) Python rebuild."""
        n_new = hi - lo
        if n_new <= 0:
            return
        new = np.empty((max(self._n + n_new, 8),), _DTYPE)
        new[:n_new] = np.arange(hi - 1, lo - 1, -1, dtype=_DTYPE)
        new[n_new:n_new + self._n] = self._buf[:self._n]
        self._buf = new
        self._n += n_new

    def remove_rows(self, rows) -> int:
        """Drop every entry present in `rows`, preserving the order of
        the remainder — ONE vectorized ``np.isin`` pass (the historical
        ``[r for r in free if r not in taken]``). Returns the number
        of entries removed."""
        arr = np.asarray(rows if isinstance(rows, np.ndarray)
                         else list(rows), np.int64)
        if not arr.size or not self._n:
            return 0
        live = self._buf[:self._n]
        keep = ~np.isin(live, arr)
        kept = live[keep]
        removed = self._n - int(kept.shape[0])
        if removed:
            self._buf[:kept.shape[0]] = kept
            self._n = int(kept.shape[0])
        return removed

    def drop_top_while_in(self, members) -> None:
        """Pop entries off the top while they appear in `members`
        (a set/dict keyed by row) — the rollback path's bounded
        'owned leftovers on top' sweep."""
        while self._n and int(self._buf[self._n - 1]) in members:
            self._n -= 1

    # -- serialization -------------------------------------------------

    def tolist(self) -> list[int]:
        """Bottom→top Python list — the checkpoint-manifest encoding
        (identical to the historical list's JSON form)."""
        return self._buf[:self._n].tolist()

    def __repr__(self) -> str:  # diagnostics only
        return f"FreeStack(n={self._n})"
