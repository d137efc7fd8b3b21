"""fcoll — collective-buffering strategies for MPI-IO.

Own copy of ``ompi_tpu/io/fcoll.py`` (≈ ``ompi/mca/fcoll/``: the
``two_phase``/``individual``/``dynamic_gen2``/``vulcan`` strategies);
it works on host bytes, which is where file data is on its way to disk.

``two_phase`` is the classic ROMIO algorithm: phase 1 exchanges data so
each aggregator owns a contiguous file region, phase 2 issues large IO
ops.  In the single-controller model phase 1's network exchange is an
in-memory merge — but the aggregation itself (coalescing every rank's
scattered view runs into few large pread/pwrite calls) is exactly the
optimization the reference buys, and it's what the strategy implements
here.  ``individual`` skips aggregation: each rank's runs are issued
directly (the fallback the reference uses when the exchange would cost
more than it saves).

All interfaces are **run-granular**: a rank's request arrives as
``[(file_offset, data_offset, length)]`` runs plus the flat data/byte
count — a contiguous GB-scale shard is a single run, never a per-byte
index array.  Only genuinely overlapping writes fall back to byte-level
resolution (MPI makes overlapping collective writes erroneous without
atomic mode; the fallback keeps them deterministic: later rank wins).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

Runs = Sequence[tuple[int, int, int]]  # (file_offset, data_offset, length)


def _intervals(per_rank: Sequence[tuple[Runs, np.ndarray]]):
    """Flatten to (file_start, file_end, rank_index, data_slice) rows in
    queue order."""
    out = []
    for ri, (runs, raw) in enumerate(per_rank):
        for file_off, data_off, length in runs:
            out.append((file_off, file_off + length, ri,
                        raw[data_off:data_off + length]))
    return out


def _has_overlap(rows) -> bool:
    srt = sorted(rows, key=lambda r: r[0])
    end = -1
    for s, e, _, _ in srt:
        if s < end:
            return True
        end = max(end, e)
    return False


def _coalesced_groups(rows):
    """Yield groups of offset-adjacent rows (rows sorted by file
    offset) — THE coalescing predicate, shared by every aggregating
    strategy so a future change (gap tolerance, group caps) lands
    once."""
    group: list = [rows[0]]
    for row in rows[1:]:
        if row[0] == group[-1][1]:
            group.append(row)
        else:
            yield group
            group = [row]
    yield group


def _group_data(group) -> np.ndarray:
    return group[0][3] if len(group) == 1 else np.concatenate(
        [g[3] for g in group])


class IndividualFcoll:
    """Each rank's runs issued as-is (≈ fcoll/individual)."""

    NAME = "individual"

    @staticmethod
    def write_all(fbtl, fd, per_rank: Sequence[tuple[Runs, np.ndarray]]) -> None:
        for runs, raw in per_rank:
            fbtl.pwritev(fd, runs, raw)

    @staticmethod
    def read_all(fbtl, fd, requests: Sequence[tuple[Runs, int]]) -> list[np.ndarray]:
        return [fbtl.preadv(fd, runs, nbytes) for runs, nbytes in requests]


class TwoPhaseFcoll:
    """Cross-rank run aggregation (≈ fcoll/two_phase).

    Writes: merge every rank's runs into one offset-sorted stream and
    coalesce adjacent runs into large pwrites.  Disjoint runs (the
    normal collective pattern — each rank owns its region) never touch
    per-byte indices; overlapping writes take the byte-resolution
    fallback where the later-queued rank deterministically wins.
    Reads: merge all requested intervals, read each merged extent once,
    scatter slices back to every requesting rank (a byte read by many
    ranks is fetched once).
    """

    NAME = "two_phase"

    @staticmethod
    def write_all(fbtl, fd, per_rank: Sequence[tuple[Runs, np.ndarray]]) -> None:
        rows = _intervals(per_rank)
        if not rows:
            return
        if _has_overlap(rows):
            TwoPhaseFcoll._write_overlapping(fbtl, fd, rows)
            return
        rows.sort(key=lambda r: r[0])
        for group in _coalesced_groups(rows):
            TwoPhaseFcoll._flush_group(fbtl, fd, group)

    @staticmethod
    def _flush_group(fbtl, fd, group) -> None:
        data = _group_data(group)
        fbtl.pwritev(fd, [(group[0][0], 0, data.nbytes)], data)

    @staticmethod
    def _write_overlapping(fbtl, fd, rows) -> None:
        """Byte-level resolution: later-queued rank wins (deterministic
        serialization of what MPI leaves undefined w/o atomic mode)."""
        idx_parts = [np.arange(s, e, dtype=np.int64) for s, e, _, _ in rows]
        all_idx = np.concatenate(idx_parts)
        all_data = np.concatenate([d for _, _, _, d in rows])
        order = np.argsort(all_idx, kind="stable")
        sorted_idx = all_idx[order]
        sorted_data = all_data[order]
        uniq, first_pos = np.unique(sorted_idx, return_index=True)
        last_pos = np.concatenate((first_pos[1:], [sorted_idx.size])) - 1
        from .file import runs_of

        fbtl.pwritev(fd, runs_of(uniq), sorted_data[last_pos])

    @staticmethod
    def read_all(fbtl, fd, requests: Sequence[tuple[Runs, int]]) -> list[np.ndarray]:
        # merge all requested extents (union, overlap-tolerant)
        extents: list[list[int]] = []
        for runs, _ in requests:
            for file_off, _, length in runs:
                extents.append([file_off, file_off + length])
        if not extents:
            return [np.empty(0, np.uint8) for _ in requests]
        extents.sort()
        merged: list[list[int]] = [extents[0][:]]
        for s, e in extents[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        # phase 1: one large read per merged extent
        starts = np.array([m[0] for m in merged], dtype=np.int64)
        buffers = [
            fbtl.preadv(fd, [(s, 0, e - s)], e - s) for s, e in merged
        ]
        # phase 2: scatter slices back to each rank
        out = []
        for runs, nbytes in requests:
            raw = np.empty(nbytes, np.uint8)
            for file_off, data_off, length in runs:
                mi = int(np.searchsorted(starts, file_off, side="right")) - 1
                base = merged[mi][0]
                raw[data_off:data_off + length] = (
                    buffers[mi][file_off - base:file_off - base + length]
                )
            out.append(raw)
        return out


class DynamicGen2Fcoll(TwoPhaseFcoll):
    """Aggregator-domain collective buffering (≈ fcoll/dynamic_gen2).

    The merged file extent is split into ``num_aggregators`` contiguous
    DOMAINS (even byte split of the touched extent — the gen2
    improvement over dynamic's static striping); each domain's runs
    coalesce independently and issue as at most one large IO per
    contiguous group per domain.  In the reference each domain belongs
    to one aggregator process; in the single-controller model the
    domain decomposition (and its IO-size consequences) is what
    remains, and is exactly what this strategy changes vs two_phase's
    global coalescing.
    """

    NAME = "dynamic_gen2"

    def __init__(self, num_aggregators: int = 4):
        self.num_aggregators = max(1, int(num_aggregators))

    def write_all(self, fbtl, fd,
                  per_rank: Sequence[tuple[Runs, np.ndarray]]) -> None:
        rows = _intervals(per_rank)
        if not rows:
            return
        if _has_overlap(rows):
            TwoPhaseFcoll._write_overlapping(fbtl, fd, rows)
            return
        lo = min(r[0] for r in rows)
        hi = max(r[1] for r in rows)
        span = max(1, hi - lo)
        ndom = min(self.num_aggregators, span)
        bounds = [lo + span * i // ndom for i in range(ndom + 1)]
        # split runs at domain boundaries, then coalesce per domain
        for d in range(ndom):
            dlo, dhi = bounds[d], bounds[d + 1]
            dom_rows = []
            for s, e, ri, data in rows:
                cs, ce = max(s, dlo), min(e, dhi)
                if cs < ce:
                    dom_rows.append((cs, ce, ri, data[cs - s:ce - s]))
            if not dom_rows:
                continue
            dom_rows.sort(key=lambda r: r[0])
            for group in _coalesced_groups(dom_rows):
                TwoPhaseFcoll._flush_group(fbtl, fd, group)

    # read_all: the two_phase merged-extent read is already
    # domain-agnostic (one pread per merged extent) — inherited.


class VulcanFcoll(TwoPhaseFcoll):
    """Stripe-aligned collective buffering (≈ fcoll/vulcan).

    Coalesced IO is re-chunked on fixed ``stripe_bytes`` boundaries so
    every write is stripe-aligned and at most one stripe long — the
    alignment contract vulcan buys for striped filesystems (Lustre).
    On a plain local fs the alignment is observable as the IO pattern;
    the bytes written are identical to two_phase's.
    """

    NAME = "vulcan"

    def __init__(self, stripe_bytes: int = 1 << 20):
        self.stripe = max(4096, int(stripe_bytes))

    def write_all(self, fbtl, fd,
                  per_rank: Sequence[tuple[Runs, np.ndarray]]) -> None:
        rows = _intervals(per_rank)
        if not rows:
            return
        if _has_overlap(rows):
            TwoPhaseFcoll._write_overlapping(fbtl, fd, rows)
            return
        rows.sort(key=lambda r: r[0])
        # coalesce adjacent, then emit stripe-aligned chunks
        for group in _coalesced_groups(rows):
            data = _group_data(group)
            start = group[0][0]
            off = 0
            while off < data.nbytes:
                pos = start + off
                take = min(self.stripe - pos % self.stripe,
                           data.nbytes - off)
                fbtl.pwritev(fd, [(pos, 0, take)], data[off:off + take])
                off += take
