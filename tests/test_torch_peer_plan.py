"""The cross-device hop's launch plan (``cuda_kernels._peer_plan``).

The plan is plain data: for each hop, per card, a credit wait, one
batched put and an arrival wait.  These tests check its shape for the
devices layout's placements (``mesh.block_devices``) of 2, 3 and 8 ranks
over 1, 2, 4 and 8 cards, and run it in a small simulator: every card's
launches in stream order against model counters, six hops, with the
landing zones' readers modelled as work that follows each hop's arrival
wait on the receiver's card, and each put as a reader of its sender's
zone of the hop before (the allgather forwards what landed).  The
simulator shows that every wait is
met by earlier work (on one card: by the work before it on the same
stream, so no wait ever spins), that no put overwrites a zone before
its readers are done, that no reader runs before its chunk landed, and
that no wait is left waiting.  The kernels themselves run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``cross_device``
phase).
"""

import itertools

import pytest
import torch

from ompi_tpu_torch.coll import cuda_kernels as ck
from ompi_tpu_torch.mesh.mesh import block_devices

U64 = (1 << 64) - 1
GRID = 132 * 8  # an H100's SMs x resident put blocks
LAYOUTS = [(cards, n) for cards in (1, 2, 4, 8) for n in (2, 3, 8)]
HOPS = 6


def placement(cards: int, n: int) -> list[int]:
    return block_devices(list(range(cards)), n)


def signed(x: int) -> int:
    x &= U64
    return x - (1 << 64) if x >> 63 else x


def simulate(cards, nbytes, hops=HOPS, epoch=0, order=None, grid=GRID):
    """Run ``hops`` hops of the plan over ranks on ``cards`` against model
    counters; returns the counters, the plans' ``expected`` and the
    number of times a wait launch found its condition unmet at the head
    of its stream."""
    n = len(cards)
    recv, consumed = [epoch & U64] * n, [epoch & U64] * n
    expected = [epoch & U64] * n
    streams = {c: [] for c in dict.fromkeys(cards)}
    for h in range(epoch, epoch + hops):
        plan, expected = ck._peer_plan(cards, h, expected, nbytes, grid)
        for launch in plan:
            streams[launch.card].append((h, launch))
        for c in streams:  # the fold or copy-out that reads the hop's zone
            streams[c].append((h, None))
    landed = set()   # (hop, receiver) whose put has run
    read = set()     # (hop, rank) whose zone has been read
    sent = set()     # (hop, sender) whose put has run
    posted = set()
    heads = dict.fromkeys(streams, 0)
    stalls = 0
    order = list(streams) if order is None else order

    def met(w):
        value = (recv if w.counter == "recv" else consumed)[w.rank]
        return signed(value - w.target) >= 0

    while any(heads[c] < len(streams[c]) for c in streams):
        progressed = False
        for c in order:
            while heads[c] < len(streams[c]):
                h, launch = streams[c][heads[c]]
                if launch is None:
                    for r in range(n):
                        if cards[r] == c:
                            assert (h, r) in landed, f"rank {r} read hop {h} before it landed"
                            read.add((h, r))
                elif launch.phase == "put":
                    for p in launch.entries:
                        # the zone (h % 2) was last written by hop h - 2 and
                        # read by its fold and by the receiver's own put of
                        # hop h - 1
                        if h - 2 >= epoch:
                            assert (h - 2, p.receiver) in read, \
                                f"hop {h} overwrote rank {p.receiver}'s zone before its reader"
                            assert (h - 1, p.receiver) in sent, \
                                f"hop {h} overwrote rank {p.receiver}'s zone before its put"
                        recv[p.receiver] = (recv[p.receiver] + p.blocks) & U64
                        landed.add((h, p.receiver))
                        sent.add((h, p.sender))
                else:
                    key = (c, heads[c])
                    if key not in posted:  # the lanes post as the kernel starts
                        posted.add(key)
                        for w in launch.entries:
                            if w.post is not None:
                                consumed[w.post] = w.post_val
                    if not all(met(w) for w in launch.entries):
                        stalls += 1
                        break
                heads[c] += 1
                progressed = True
        assert progressed, f"deadlock: heads {heads}"
    return recv, consumed, expected, stalls


@pytest.mark.parametrize("cards,n", LAYOUTS, ids=[f"{c}cards-n{n}" for c, n in LAYOUTS])
def test_each_card_gets_one_put_and_two_waits_per_hop(cards, n):
    place = placement(cards, n)
    used = sorted(set(place))
    expected = [5] * n
    for hop in range(3):
        plan, new = ck._peer_plan(place, hop, expected, 4096 * 4, GRID)
        by_card = {c: [launch.phase for launch in plan if launch.card == c] for c in used}
        assert by_card == {c: ["credit", "put", "arrival"] for c in used}
        # every card's credit wait and put before any arrival wait
        phases = [launch.phase for launch in plan]
        assert phases.index("arrival") == 2 * len(used)
        puts = [p for launch in plan if launch.phase == "put" for p in launch.entries]
        assert sorted(p.sender for p in puts) == list(range(n))
        assert all(p.receiver == (p.sender + 1) % n for p in puts)
        assert all(place[p.sender] == launch.card for launch in plan
                   if launch.phase == "put" for p in launch.entries)
        credit = [w for launch in plan if launch.phase == "credit" for w in launch.entries]
        assert {(w.flag, w.rank) for w in credit} == {(r, (r + 1) % n) for r in range(n)}
        assert all(w.counter == "consumed" and w.post is None
                   and w.target == (hop - 1) & U64 for w in credit)
        arrival = {w.rank: w for launch in plan if launch.phase == "arrival"
                   for w in launch.entries}
        assert sorted(arrival) == list(range(n))
        for r, w in arrival.items():
            assert place[r] == next(launch.card for launch in plan
                                    if launch.phase == "arrival" and w in launch.entries)
            assert (w.post, w.post_val, w.counter, w.flag) == (r, hop, "recv", r)
        added = {p.receiver: p.blocks for p in puts}
        assert new == [(expected[r] + added[r]) & U64 for r in range(n)]
        assert all(arrival[r].target == new[r] for r in range(n))
        expected = new


@pytest.mark.parametrize("n,cards,launches", [(16, 1, 1), (17, 1, 2), (40, 1, 3),
                                              (40, 2, 4)])
def test_more_ranks_than_entries_split_into_further_launches(n, cards, launches):
    place = placement(cards, n)
    plan, _ = ck._peer_plan(place, 0, [0] * n, 100, GRID)
    for phase in ("credit", "put", "arrival"):
        mine = [launch for launch in plan if launch.phase == phase]
        assert len(mine) == launches
        assert all(1 <= len(launch.entries) <= ck.PEER_MAX_ENTRIES for launch in mine)
    assert [launch.phase for launch in plan] == ["credit", "put"] * launches + \
        ["arrival"] * launches


@pytest.mark.parametrize("nbytes,per_put", [
    (0, 1), (1, 1), (ck.PEER_BLOCK_BYTES, 1), (ck.PEER_BLOCK_BYTES + 1, 2),
    (1 << 27, GRID)])
def test_blocks_are_split_among_a_cards_puts(nbytes, per_put):
    """Each of the eight puts on one card gets one wave of the card's
    resident blocks (the kernel interleaves them); a small put takes one
    block per unrolled pass, and at least one (its signal)."""
    plan, new = ck._peer_plan([0] * 8, 0, [0] * 8, nbytes, GRID)
    (put,) = [launch for launch in plan if launch.phase == "put"]
    assert [p.blocks for p in put.entries] == [per_put] * 8
    assert new == [per_put] * 8


@pytest.mark.parametrize("nbytes", [1, 1 << 27])
@pytest.mark.parametrize("cards,n", LAYOUTS + [(2, 3), (1, 20), (2, 40)],
                         ids=[f"{c}cards-n{n}" for c, n in LAYOUTS + [(2, 3), (1, 20), (2, 40)]])
def test_simulated_hops_meet_every_wait_with_earlier_work(cards, n, nbytes):
    place = placement(cards, n)
    for order in (None, sorted(set(place), reverse=True)):
        recv, consumed, expected, stalls = simulate(place, nbytes, order=order)
        assert recv == expected          # every put's signals, no more, no fewer
        assert consumed == [HOPS - 1] * n
        if len(set(place)) == 1:
            assert stalls == 0           # one stream: each wait is already met


@pytest.mark.parametrize("epoch,wraps", [((1 << 64) - 3, True), ((1 << 64) - 1, True),
                                         ((1 << 63) - 2, False)])
def test_counters_near_the_wrap_keep_the_order(epoch, wraps):
    """Pages that start near 2^64 (and near the signed midpoint): the
    signed compare holds the order across the wrap."""
    for cards, n in ((1, 8), (4, 8), (2, 3)):
        place = placement(cards, n)
        recv, consumed, expected, _ = simulate(place, 1 << 20, epoch=epoch)
        assert recv == expected
        assert consumed == [(epoch + HOPS - 1) & U64] * n
        assert all(e < epoch for e in expected) == wraps  # the arrivals wrapped


def test_a_lost_signal_is_a_wait_left_waiting(monkeypatch):
    """The simulator's deadlock check bites: drop one put and the arrival
    wait of its receiver never completes."""
    place = placement(1, 3)
    plan, new = ck._peer_plan(place, 0, [0] * 3, 64, GRID)
    put = next(launch for launch in plan if launch.phase == "put")
    broken = [launch._replace(entries=put.entries[1:]) if launch is put else launch
              for launch in plan]
    monkeypatch.setattr(ck, "_peer_plan", lambda *a: (broken, new))
    with pytest.raises(AssertionError, match="deadlock"):
        simulate(place, 64, hops=1)


def test_the_plan_is_what_the_wrapper_would_launch_per_hop():
    """The launches of a whole allreduce on the devices layout, as the
    plan counts them: 2(n-1) hops, per hop one put and two waits per card
    (``chip_smoke.py``'s and the card tests' launch expectations)."""
    for cards, n in itertools.product((1, 2, 4, 8), (2, 3, 8)):
        place = placement(cards, n)
        puts = waits = 0
        expected = [0] * n
        for hop in range(2 * (n - 1)):
            plan, expected = ck._peer_plan(place, hop, expected, 1 << 20, GRID)
            puts += sum(launch.phase == "put" for launch in plan)
            waits += sum(launch.phase != "put" for launch in plan)
        used = len(set(place))
        assert (puts, waits) == (2 * (n - 1) * used, 4 * (n - 1) * used)


@pytest.mark.parametrize("src,dst,width", [
    (4096, 8192, 16), (4100, 8196, 16), (4097, 8209, 16),   # the ends agree modulo 16
    (4100, 8192, 4), (4104, 8192, 8), (4098, 8192, 2), (4097, 8192, 1)])
def test_put_body_words_are_as_wide_as_the_ends_agree(src, dst, width):
    assert ck.put_word_bytes(src, dst) == width


def test_a_ring_starts_at_its_epoch():
    """A ring's epochs start where asked (the card's wrap case starts its
    pages three hops below 2^64); its hops count on from there."""
    ring = ck.PeerRing([torch.device("cpu")] * 3, epoch=(1 << 64) - 3)
    assert ring.hops == (1 << 64) - 3 and ring.expected == [(1 << 64) - 3] * 3
    land = ring.landing(16)
    ck.ring_hop_peer([torch.ones(4)] * 3, [0] * 3, [z.view(torch.float32) for z in land],
                     [0] * 3, 4, ring)
    assert ring.hops == (1 << 64) - 2
    assert all(z.view(torch.float32).tolist() == [1.0] * 4 for z in land)
