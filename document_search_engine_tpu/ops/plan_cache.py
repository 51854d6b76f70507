"""Stable compiled-plan layouts: bound the serving jit-signature space.

The batch step is jit-compiled with the bucket plan as a STATIC argument
(engine/engine.py _batch_step), so every distinct plan tuple is a full
XLA program — ~20 MB of compiled executable at production shapes. Left
alone, each incoming batch produces its own natural plan (pow-2 bucket
counts flap with sampling noise: 63 vs 65 queries in a cell is a new
(bq,) shape), and a serving process accumulates programs without bound:
one compile per batch.

This module canonicalizes natural plans into a per-engine stable layout:

- A layout is a tuple of cells (n_blocks, block, r_c, bq): the compiled
  bucket grid with fixed pow-2 capacities.
- Each batch's natural buckets are FITTED into the layout: every query
  group goes to the smallest cell that dominates its need (same block;
  cell n_blocks >= bucket n_blocks; cell r_c >= bucket r_c) with free
  capacity, spilling to larger cells when full. Domination is safe by
  construction — pow-2 bucketing already runs queries at budgets up to
  2x their need, and neither the DMA plan expansion nor the compacted
  candidate buffer assumes the budget is tight.
- A batch that fits is a HIT: zero new programs, the one resident
  executable serves it. Cells with no queries this batch still run
  (zero-padded rows score nothing) — the stability is the point.
- A batch that does not fit GROWS the layout once: demanded cells are
  added (tiny ones first folded into a dominating cell so sampling
  noise cannot mint single-query cells) with `headroom` slack on their
  pow-2 capacity, and the key recompiles. Layouts converge after one or
  two batches of representative traffic and then never change.
"""
from __future__ import annotations

import numpy as np


# capacity granule: every cell capacity is a multiple of this, which
# bounds the distinct bq shapes a layout can grow through
GRANULE = 16


def _pow2_at_least(n: int, lo: int = 1) -> int:
    n = max(n, lo)
    return 1 << int(np.ceil(np.log2(n)))


def _dominates(cell, nb: int, blk: int, rc: int) -> bool:
    c_nb, c_blk, c_rc, _bq = cell
    return c_blk == blk and c_nb >= nb and c_rc >= rc


def _fit(layout, natural):
    """Assign natural buckets [(idx, nb, blk, rc)] to layout cells.

    Returns (assignments, None) on success — assignments[i] is the
    concatenated query-index array for layout cell i — or
    (None, (nb, blk, rc)) naming the first unplaceable bucket.
    Buckets are placed most-constrained first; each pours into its
    smallest dominating cell, spilling upward when a cell fills."""
    free = [bq for (_nb, _blk, _rc, bq) in layout]
    pieces = [[] for _ in layout]
    order = sorted(
        range(len(natural)),
        key=lambda i: (natural[i][1], natural[i][3]),
        reverse=True,
    )
    for bi in order:
        idx, nb, blk, rc = natural[bi]
        remaining = np.asarray(idx)
        cand = [
            ci
            for ci, cell in enumerate(layout)
            if _dominates(cell, nb, blk, rc)
        ]
        # smallest dominating first (layout is kept sorted ascending)
        for ci in cand:
            if len(remaining) == 0:
                break
            take = min(free[ci], len(remaining))
            if take <= 0:
                continue
            pieces[ci].append(remaining[:take])
            free[ci] -= take
            remaining = remaining[take:]
        if len(remaining):
            return None, (nb, blk, rc)
    out = [
        (
            np.concatenate(p)
            if p
            else np.zeros(0, dtype=np.int64)
        )
        for p in pieces
    ]
    return out, None


class PlanLayoutCache:
    """Per-engine registry of stable compiled-plan layouts (module
    docstring). One instance per engine; keys identify everything else
    static about the program (segment geometry, s, k, scorer mode)."""

    def __init__(
        self, headroom: float = 1.05, min_cell_frac: float = 1 / 64
    ):
        # capacity rule: demand * headroom rounded up to GRANULE. The
        # layout itself is the jit signature, so capacities need NOT be
        # pow-2 like the natural per-batch plans — a 3300-query cell
        # gets 3472 slots instead of 4096 (less padded rank work at the
        # same layout-growth rate).
        self.headroom = headroom
        self.min_cell_frac = min_cell_frac
        self._layouts: dict = {}  # key -> tuple[(nb, blk, rc, bq), ...]
        self.hits = 0
        self.grows = 0  # layout (re)compiles

    def stats(self) -> str:
        cells = sum(len(v) for v in self._layouts.values())
        return (
            f"layouts={len(self._layouts)} cells={cells} "
            f"hits={self.hits} grows={self.grows}"
        )

    def to_jsonable(self) -> list:
        """JSON-serializable snapshot of the converged layouts (for the
        index checkpoint — a freshly loaded index would otherwise re-pay
        layout growth, a compile per growth, before settling). Keys are
        tuples of ints/strings/None/nested tuples, so repr() is an
        exact, literal_eval-able encoding."""
        return [
            [repr(key), [list(cell) for cell in layout]]
            for key, layout in sorted(
                self._layouts.items(), key=lambda kv: repr(kv[0])
            )
        ]

    def load_jsonable(self, data) -> None:
        """Restore layouts saved by to_jsonable. Restoring does not
        count as growth: a serving process whose traffic fits the
        restored layouts compiles each one exactly once (a disk-cache
        hit when the persistent compile cache is warm) and never
        recompiles. Unparseable entries are skipped — a checkpoint
        written by a newer key schema must not fail the load."""
        import ast

        for key_str, cells in data:
            try:
                key = ast.literal_eval(key_str)
            except (ValueError, SyntaxError):
                continue
            self._layouts[key] = tuple(
                tuple(int(x) for x in cell) for cell in cells
            )

    def canonicalize(self, key, natural, nq: int):
        """Map a batch's natural plan [(idx, nb, blk, rc)] onto the
        stable layout for `key`, growing it when needed. Returns
        [(idx, nb, blk, rc, bq)] — one entry per layout cell, in layout
        order (idx possibly empty)."""
        natural = [
            (np.asarray(idx), int(nb), int(blk), int(rc))
            for idx, nb, blk, rc in natural
        ]
        layout = self._layouts.get(key)
        if layout is not None:
            assignments, fail = _fit(layout, natural)
            if assignments is not None:
                self.hits += 1
                return [
                    (a, nb, blk, rc, bq)
                    for a, (nb, blk, rc, bq) in zip(assignments, layout)
                ]
        layout = self._grow(layout, natural, nq)
        # bump capacities until the batch fits (the aggregate-capacity
        # corner case where spill ordering beats per-cell headroom)
        for _ in range(64):
            assignments, fail = _fit(layout, natural)
            if assignments is not None:
                break
            nb, blk, rc = fail
            layout = _bump(layout, nb, blk, rc)
        assert assignments is not None, "plan layout failed to converge"
        self._layouts[key] = layout
        self.grows += 1
        return [
            (a, nb, blk, rc, bq)
            for a, (nb, blk, rc, bq) in zip(assignments, layout)
        ]

    def _grow(self, old, natural, nq: int):
        """New layout covering `natural`: demand cells aggregated, tiny
        ones folded into a dominating cell, capacities = pow-2 of
        demand * headroom, merged with (and never shrinking) `old`."""
        demand: dict = {}
        for idx, nb, blk, rc in natural:
            k = (nb, blk, rc)
            demand[k] = demand.get(k, 0) + len(idx)
        min_count = max(8, int(nq * self.min_cell_frac))
        # fold tiny demand cells upward (ascending need order) so noise
        # cells never become compiled cells
        for k in sorted(demand):
            if demand.get(k, 0) >= min_count:
                continue
            nb, blk, rc = k
            doms = sorted(
                kk
                for kk in demand
                if kk != k
                and kk[1] == blk
                and kk[0] >= nb
                and kk[2] >= rc
            )
            if doms:
                demand[doms[0]] += demand.pop(k)
        cells = {(nb, blk, rc): bq for nb, blk, rc, bq in (old or ())}
        for (nb, blk, rc), count in demand.items():
            # headroom absorbs the per-batch sampling flap (~±5% per
            # cell on bench traffic); floor 16 keeps noise cells from
            # compiling tiny sub-programs
            need = -(-max(int(count * self.headroom), 16) // GRANULE)
            need *= GRANULE
            cells[(nb, blk, rc)] = max(cells.get((nb, blk, rc), 0), need)
        return tuple(
            (nb, blk, rc, bq)
            for (nb, blk, rc), bq in sorted(cells.items())
        )

    def seed_plans(self, key, naturals, nq: int) -> None:
        """Converge the layout for `key` over SEVERAL batches' natural
        plans in one growth, before anything compiles.

        Serving cold-start pays one compile per layout GENERATION, so
        growing batch-by-batch during warmup pays for
        every intermediate generation. Seeding computes each shape's
        max per-batch demand across `naturals` (host-only numpy) and
        grows once: the first dispatch compiles the final layout and
        every subsequent batch of the same traffic hits it."""
        # sequential fit-then-grow, exactly the serving path's policy but
        # with no compile between generations. (Sizing each cell to its
        # max demand across batches instead overshoots ~17%: a query is
        # in exactly one cell, so per-cell counts anti-correlate and the
        # union-of-maxima grid exceeds any single batch's total.)
        layout = self._layouts.get(key)
        for natural in naturals:
            nat = [
                (np.asarray(idx), int(nb), int(blk), int(rc))
                for idx, nb, blk, rc in natural
            ]
            if layout is not None:
                assignments, _fail = _fit(layout, nat)
                if assignments is not None:
                    continue
            layout = self._grow(layout, nat, nq)
            for _ in range(64):
                assignments, fail = _fit(layout, nat)
                if assignments is not None:
                    break
                layout = _bump(layout, *fail)
            assert assignments is not None, "seed layout failed to fit"
        if layout is not None and layout != self._layouts.get(key):
            self._layouts[key] = layout
            self.grows += 1


def _bump(layout, nb: int, blk: int, rc: int):
    """Grow the smallest cell dominating (nb, blk, rc) by ~1/8 of its
    capacity (granule-rounded), or add an exact cell if none exists."""
    cand = sorted(
        ci
        for ci, cell in enumerate(layout)
        if _dominates(cell, nb, blk, rc)
    )
    cells = list(layout)
    if cand:
        c_nb, c_blk, c_rc, bq = cells[cand[0]]
        step = max(GRANULE, bq // 8 // GRANULE * GRANULE)
        cells[cand[0]] = (c_nb, c_blk, c_rc, bq + step)
    else:
        cells.append((nb, blk, rc, 16))
    return tuple(sorted(cells))
