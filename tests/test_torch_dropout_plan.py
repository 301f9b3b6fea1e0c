"""csrc/dropout.cu's launch plan (ops/dropout.plan), on the CPU.

The kernel cuts each segment of a window into slots of 16 bytes of
elements whose first unsharded index is a multiple of 4 (whole Philox
counters) and walks them in a persistent grid.  ``slot_table`` below is
the test's model of that arithmetic (csrc/dropout.cu ``locate``) in plain
torch; these tests hold it and the plan to the window: every element
of the shard taken exactly once, at its unsharded index
(``window_indices``), each Philox counter of a segment in one slot, and a
segment's ragged head, vector interior and ragged tail adding up to it.
The cases are the main path's whole tensors and shards and the attention
probabilities' windows at T = 99, whose segments start off a multiple of 4,
at a smaller batch.  The kernel's own bits are held to the plain version on
the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from tethys_tpu_torch.ops import dropout

W = dropout.Window
# (shape, window, element bytes, 16-byte aligned pointers)
CASES = {
    "whole bf16": ((4, 150, 512), W(), 2, True),
    "whole f32": ((4, 150, 512), W(), 4, True),
    "whole, ragged tail": ((3, 7, 11), W(), 2, True),
    "whole, unaligned pointer": ((3, 7, 16), W(), 4, False),
    "rows 75-149 of 150": ((4, 75, 512), W(row0=75, rows=150), 2, True),
    "columns 256-511 of 512": ((4, 150, 256), W(col0=256, cols=512), 2, True),
    "columns, odd width": ((3, 10, 11), W(col0=1, cols=12), 4, True),
    # probabilities [2, 12, 99, 99], flattened [2, 12 * 99, 99] for heads
    "heads 6-11 of 12, T 99": ((2, 6 * 99, 99), W(row0=6 * 99, rows=12 * 99),
                               2, True),
    "heads 6-11 of 12, T 99, f32": ((2, 6 * 99, 99),
                                    W(row0=6 * 99, rows=12 * 99), 4, True),
    "query rows 50-98 of 99": ((2, 12, 49, 99), W(row0=50, rows=99), 2, True),
    "query rows 49-98 of 99": ((2, 12, 50, 99), W(row0=49, rows=99), 2, True),
    "heads 6-11 of 12, T 100": ((2, 6 * 100, 100),
                                W(row0=6 * 100, rows=12 * 100), 2, True),
}


def divider(d: int):
    """(m, p) with w // d == (w * m) >> p for every 0 <= w < 2^31: how the
    kernel divides a slot index by a segment's slots (and a segment index
    by the segments an outer index) without a division (csrc/dropout.cu
    ``divider``)."""
    p = 31 + (d - 1).bit_length()
    m = (1 << p) // d + 1
    assert m < 2 ** 32
    return m, p


def slot_table(p) -> dict:
    """What each slot of launch ``p`` takes, by csrc/dropout.cu's
    arithmetic (``locate``, ``access_width``), as int64 tensors over the
    slots: ``seg`` (its segment), ``x0`` (the shard index of its position
    0, which may precede the segment), ``n0`` (the unsharded index there, a
    multiple of 4: the slot takes vec / 4 whole Philox counters from
    n0 // 4), ``lo`` and ``hi`` (its positions in the segment: lo <= e <
    hi, none where lo >= hi) and ``width`` (elements a load or store moves:
    vec, one 16-byte access; 2 where the slot is whole at an even index;
    else 1)."""
    seg_len, per_outer, outer_stride, row_stride, base = p.segments
    vec = p.vec
    w = torch.arange(p.slots, dtype=torch.int64)
    m, sh = divider(p.slots_per_seg)
    seg = (w * m) >> sh
    k = w - seg * p.slots_per_seg
    if per_outer > 1:
        m, sh = divider(per_outer)
        outer = (seg * m) >> sh
    else:
        outer = seg
    u = outer * outer_stride + (seg - outer * per_outer) * row_stride + base
    x_seg = seg * seg_len
    # The head: up to the first index whose slots are whole counters and,
    # where the window keeps x and the unsharded index 4-aligned together,
    # 16-byte aligned in x.
    head = torch.where((u - x_seg) % 4 == 0, (-x_seg) % vec, (-u) % 4)
    o = head + (k - 1) * vec
    lo = (-o).clamp(0, vec)
    hi = (seg_len - o).clamp(0, vec)
    x0 = x_seg + o
    whole = (lo == 0) & (hi == vec) & p.vectors
    width = torch.where(whole & (x0 % vec == 0), vec,
                        torch.where(whole & (x0 % 2 == 0), 2, 1))
    return {"seg": seg, "x0": x0 + p.offset, "n0": u + o, "lo": lo,
            "hi": hi, "width": width}


def _elements(p):
    """(slot, x index, unsharded index) of every element launch ``p``
    writes."""
    t = slot_table(p)
    slot, x, n = [], [], []
    for e in range(p.vec):
        take = (t["lo"] <= e) & (e < t["hi"])
        idx = take.nonzero()[:, 0]
        slot.append(idx)
        x.append(t["x0"][idx] + e)
        n.append(t["n0"][idx] + e)
    return t, torch.cat(slot), torch.cat(x), torch.cat(n)


def _covers_once(shape, window, elem, vectors, max_launch):
    """Every launch within MAX_LAUNCH elements and 32-bit counts, the
    launches' elements the shard's, each once, at its unsharded index, in
    whole Philox counters, each counter of a launch's segment in one
    slot."""
    launches = dropout.plan(shape, window, elem, vectors, 8, 132)
    numel = int(np.prod(shape))
    xs, ns = [], []
    for p in launches:
        assert p.numel <= max_launch and p.segments[0] <= max_launch
        assert p.slots < 2 ** 31
        t, slot, x, n = _elements(p)
        assert bool((x >= p.offset).all()) and bool(
            (x < p.offset + p.numel).all())
        assert bool((t["n0"] % 4 == 0).all())
        assert bool(((n // 4 - t["n0"][slot] // 4) < p.vec // 4).all())
        pairs = torch.unique(torch.stack([t["seg"][slot], n // 4, slot]),
                             dim=1)
        assert pairs.shape[1] == torch.unique(pairs[:2], dim=1).shape[1]
        xs.append(x)
        ns.append(n)
    x, n = torch.cat(xs), torch.cat(ns)
    assert torch.equal(torch.sort(x).values, torch.arange(numel))
    assert torch.equal(n, dropout.window_indices(shape, window)[x])
    return launches


@pytest.mark.parametrize("case", list(CASES))
def test_plan_covers_the_shard_once(case):
    assert len(_covers_once(*CASES[case], dropout.MAX_LAUNCH)) == 1


@pytest.mark.parametrize("max_launch", [64, 600, 5000])
@pytest.mark.parametrize("case", list(CASES))
def test_split_plan_covers_the_shard_once(case, max_launch, monkeypatch):
    """A shard of more than MAX_LAUNCH elements (here made small) takes
    several launches: a long segment in runs, an outer index's segments in
    runs, or runs of whole outer indices; together they still take every
    element once at its unsharded index."""
    monkeypatch.setattr(dropout, "MAX_LAUNCH", max_launch)
    launches = _covers_once(*CASES[case], max_launch)
    numel = int(np.prod(CASES[case][0]))
    assert len(launches) >= -(-numel // max_launch)


@pytest.mark.parametrize("case", list(CASES))
def test_plan_head_vectors_tail_add_up(case):
    """A segment is its head (the slot before the first aligned one), its
    interior of whole slots and its tail; each end is shorter than a slot.
    The interior moves in 16-byte vectors exactly where x and the unsharded
    index stay 4-aligned together and the pointers allow it, in pairs
    where they are 2 apart, else element by element."""
    shape, window, elem, vectors = CASES[case]
    (p,) = dropout.plan(shape, window, elem, vectors, 8, 132)
    seg_len = p.segments[0]
    t = slot_table(p)
    size = (t["hi"] - t["lo"]).clamp(min=0)
    first = torch.arange(p.slots) % p.slots_per_seg == 0
    whole = size == p.vec
    segs = p.slots // p.slots_per_seg

    def per_seg(take):
        return torch.zeros(segs, dtype=torch.int64).index_add_(
            0, t["seg"], size * take)

    head, interior = per_seg(first), per_seg(whole & ~first)
    tail = per_seg(~whole & ~first)
    assert torch.equal(head + interior + tail, torch.full((segs,), seg_len))
    assert bool((head < p.vec).all()) and bool((tail < p.vec).all())
    x_seg = torch.arange(segs) * seg_len
    apart = (dropout.window_indices(shape, window)[x_seg] - x_seg) % 4
    for width, where in ((p.vec, apart == 0), (2, apart == 2)):
        want = interior * (where & vectors)
        assert torch.equal(per_seg(whole & (t["width"] == width)), want)
    assert bool((t["width"][~whole] == 1).all())
    if case.startswith("whole bf16"):
        assert int(interior.sum()) == seg_len    # all of it in vectors


def test_plan_grid():
    """bf16: one wave of the card at most, one slot a thread below that;
    f32: one slot a thread; the main path's tensors and probabilities
    windows."""
    (p,) = dropout.plan((16, 1500, 512), W(), 2, True, 8, 132)
    assert (p.offset, p.vec, p.slots_per_seg, p.slots, p.blocks) == (
        0, 8, 16 * 1500 * 512 // 8 + 1, 16 * 1500 * 512 // 8 + 1, 8 * 132)
    (p,) = dropout.plan((16, 1500, 512), W(), 4, True, 6, 132)
    assert (p.vec, p.blocks) == (4, -(-(16 * 1500 * 512 // 4 + 1) // 256))
    (heads,) = dropout.plan((8, 6 * 99, 99), W(row0=6 * 99, rows=12 * 99), 2,
                            True, 8, 132)
    assert heads.segments == (6 * 99 * 99, 1, 12 * 99 * 99, 0, 6 * 99 * 99)
    assert heads.slots == 8 * (-(-6 * 99 * 99 // 8) + 1)
    assert heads.blocks == -(-heads.slots // dropout.THREADS) < 8 * 132
    (rows,) = dropout.plan((8, 12, 49, 99), W(row0=50, rows=99), 2, True, 8,
                           132)
    assert rows.segments == (49 * 99, 1, 99 * 99, 0, 50 * 99)
    assert rows.slots == 8 * 12 * (-(-49 * 99 // 8) + 1)
    assert dropout.plan((1, 1), W(), 2, True, 8, 132)[0].blocks == 1


def test_plan_splits_a_large_tensor():
    """Past 2^29 elements a shard takes several launches, each a run of its
    window whose base is the unsharded index of its first element: 2^30
    elements in two; wav2vec2-large's attention probabilities on 30 s clips
    at batch 30, [30, 16, 1500, 1500], in three; a row shard of them in
    runs of whole segments; a column shard whose one outer index holds more
    than 2^29 elements in runs of its rows."""
    big = 2 ** 29
    assert dropout.MAX_LAUNCH == big
    halves = dropout.plan((2 ** 30,), W(), 2, True, 8, 132)
    assert [(p.offset, p.numel, p.segments) for p in halves] == [
        (0, big, (big, 1, 0, 0, 0)), (big, big, (big, 1, 0, 0, big))]
    assert all(p.vectors and p.blocks == 8 * 132 for p in halves)
    shape = (30, 16, 1500, 1500)
    numel = 30 * 16 * 1500 * 1500
    probs = dropout.plan(shape, W(), 2, True, 8, 132)
    assert [(p.offset, p.numel) for p in probs] == [
        (0, big), (big, big), (2 * big, numel - 2 * big)]
    assert [p.segments[4] for p in probs] == [0, big, 2 * big]
    assert all(p.slots < 2 ** 31 for p in probs)
    rows = dropout.plan((30 * 16, 750, 1500), W(row0=750, rows=1500), 4,
                        True, 8, 132)
    per = big // (750 * 1500)                   # segments a launch
    assert len(rows) == -(-30 * 16 // per)
    assert rows[1].offset == per * 750 * 1500
    assert rows[1].segments == (750 * 1500, 1, 1500 * 1500, 0,
                                per * 1500 * 1500 + 750 * 1500)
    cols = dropout.plan((2 ** 21, 2 ** 12), W(col0=2 ** 12, cols=2 ** 13),
                        2, True, 8, 132)
    run = big // 2 ** 12
    assert len(cols) == 2 ** 21 // run
    assert cols[3].segments == (2 ** 12, run, 0, 2 ** 13,
                                3 * run * 2 ** 13 + 2 ** 12)
    assert cols[3].offset == 3 * run * 2 ** 12


@pytest.mark.parametrize("d", [1, 2, 3, 7, 8, 97, 99, 608, 4852, 7351,
                               65537, 1536001, 2 ** 30 - 3, 2 ** 31 - 1])
def test_divider_is_exact(d):
    """The kernel's division by a multiply and a shift equals // on every
    slot index a launch can have (below 2^31)."""
    m, p = divider(d)
    rng = np.random.default_rng(d)
    # Each multiple of d and the index before it, from the first and the
    # last quotients, and random indices.
    q = np.concatenate([np.arange(2048), (2 ** 31 - 1) // d - np.arange(2048)])
    w = torch.from_numpy(np.concatenate([
        rng.integers(0, 2 ** 31, 4096), q * d, q * d - 1,
        [2 ** 31 - 1, 2 ** 31 - 2]]).astype(np.int64))
    w = w[(w >= 0) & (w < 2 ** 31)]
    assert torch.equal((w * m) >> p, w // d)
