"""The order-statistic kernel's algorithm (atq_tpu_torch/csrc/order_stat.cu)
as a numpy model, held bit for bit against ``np.sort`` and against the JAX
package's ``order_statistic_reductions`` and
``order_statistic_reductions_batched`` (their Pallas kernels under the
interpreter, as tests/test_pallas_interpret.py runs them).

The model runs the kernel's plan over the rows serially: the cluster size
and residency the launch picks, each CTA's segment and held part, the
12/10/10-bit digit plan, the coarse-then-fine bin choice over the merged
histograms, the window of digit-0 bins estimated from the held sample of a
longer row with the mass below and above it, the candidate lists with their
capacities, the fall-backs (a window that misses: digit 0 counted again; a
CTA whose window candidates overflow: its segment re-read; digit 1's list
that overflows: digit 2 counted over digit 1's sources), and the float64 sum
in the kernel's fixed order. Its constants are read from the CUDA source, so a
change of plan there that is not made here fails. A scaled-down plan (small
blocks and pools) drives every path at sizes the CPU runs in seconds; each
path is asserted to occur. A planted fault (a compaction that drops the
chosen bin's last element) must fail the same checks.

The kernel itself is held against the sort on the card by
tests/test_torch_cuda_kernels.py and ``chip_smoke.py``.
"""

import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest

import atq_tpu_torch

CU = pathlib.Path(atq_tpu_torch.__file__).parent / "csrc" / "order_stat.cu"


@dataclasses.dataclass(frozen=True)
class Plan:
    threads: int
    unroll: int
    pipe: int
    first_bits: int
    rest_bits: int
    coarse: int
    pool: int
    hold: int
    stream_hold: int
    window_div: int
    window_pad: int


def _kernel_plan() -> Plan:
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    return Plan(threads=const("kThreads"), unroll=const("kUnroll"),
                pipe=const("kPipe"),
                first_bits=const("kFirstBits"), rest_bits=const("kRestBits"),
                coarse=const("kCoarse"), pool=const("kPoolWords"),
                hold=const("kHoldWords"),
                stream_hold=const("kStreamHoldWords"),
                window_div=const("kWindowDiv"), window_pad=const("kWindowPad"))


KERNEL = _kernel_plan()
# Small blocks and pools: rows of a few thousand elements take clusters of
# up to 16, longer rows the window, and one bin can overflow a CTA's pool.
SMALL = dataclasses.replace(KERNEL, threads=64, unroll=2, pipe=1, pool=1024,
                            hold=640, stream_hold=256, window_pad=16)
# Clusters of 1, 2, 4, 8 and 16 full-size CTAs a card holds at once (an
# H100's 132 SMs; 16 only in the GPCs that have 16 free).
ACTIVE = {1: 132, 2: 66, 4: 33, 8: 16, 16: 7}


def seg_len(n, c):
    return (-(-n // c) + 3) // 4 * 4


def cluster_plan(n, rows, plan, active=ACTIVE):
    """atq_order_stat_plan: the fewest CTAs that hold a row if all rows run
    at once; else 16 or 8 a row, whichever needs fewer waves, resident
    first, then the larger."""
    cmax = 16 if active[16] > 0 else 8
    best, best_res, best_waves = 0, False, 0
    c = 1
    while c <= cmax:
        res = seg_len(n, c) <= plan.hold
        if res or c >= cmax // 2:
            waves = -(-rows // active[c])
            if (best == 0 or waves < best_waves
                    or (waves == best_waves and (res or not best_res))):
                best, best_res, best_waves = c, res, waves
            if res:
                break
        c *= 2
    return best, best_res


def select(hist, r, coarse):
    """cluster_select: the coarse bin whose running total first exceeds r,
    then the fine bin inside it; returns (bin, rank left in the bin)."""
    nb = len(hist)
    per = nb // coarse
    ctot = hist.reshape(coarse, per).sum(axis=1)
    cb, r1 = _find(ctot, r)
    f, r2 = _find(hist[cb * per:(cb + 1) * per], r1)
    return cb * per + f, r2


def _find(tot, r):
    incl = np.cumsum(tot)
    hit = np.nonzero(incl > r)[0]
    i = int(hit[0]) if len(hit) else len(tot) - 1
    return i, int(r - (incl[i] - tot[i]))


def _thread_sums(parts, plan, vec):
    """Each thread's float64 sum over the ranges ``parts`` of one segment in
    turn (as the kernel's passes), in index order: each 4 elements of a
    step summed pairwise in float32, (e0 + e1) + (e2 + e3), then added in
    float64. 16-byte steps: a vector's four elements, the last < 4 elements
    alone; 4-byte steps: rounds 4g..4g+3 of a step (round j holds element j
    of every thread)."""
    t = plan.threads
    acc = np.zeros(t, np.float64)

    def add(quads):  # (T, 4) float32 groups, in order
        s = (quads[:, 0] + quads[:, 1]) + (quads[:, 2] + quads[:, 3])
        acc[:] += s.astype(np.float64)

    for x in parts:
        x = x.view(np.float32)
        if vec:
            nv = len(x) // 4
            body = np.zeros((-(-nv // t) * t, 4), np.float32)
            body[:nv] = x[:4 * nv].reshape(nv, 4)
            for blk in body.reshape(-1, t, 4):
                add(blk)
            tail = np.zeros((t, 4), np.float32)
            tail[:len(x) - 4 * nv, 0] = x[4 * nv:]
            add(tail)
        else:
            step = 4 * plan.unroll * t
            body = np.zeros(-(-len(x) // step) * step, np.float32)
            body[:len(x)] = x
            for rnd in body.reshape(-1, 4, t):  # 4 rounds: (4, T)
                add(rnd.T)
    return acc


def _cta_sum(acc, plan):
    """A butterfly in each warp, then one over the warps (float64)."""
    lanes = np.arange(32)
    a = acc.reshape(-1, 32)
    for off in (16, 8, 4, 2, 1):
        a = a + a[:, lanes ^ off]
    w = a[:, 0]
    idx = np.arange(len(w))
    off = len(w) // 2
    while off:
        w = w + w[idx ^ off]
        off //= 2
    return w[0]


def _stream_threads(n, plan, vec):
    """The thread that streams each of n elements of a segment (stream16
    for 16-byte rows: vector q to thread q % T, the last < 4 elements to
    threads 0..; for_each_step otherwise: element i to thread i % T). A
    thread meets its elements in index order."""
    t, i = plan.threads, np.arange(n)
    if vec:
        nv = n // 4
        return np.where(i < 4 * nv, (i // 4) % t, i - 4 * nv)
    return i % t


def _held_threads(n, plan):
    """The thread that reads each of n held words (for_each_step_held:
    16-byte reads whatever the row's alignment)."""
    t, i = plan.threads, np.arange(n)
    nv = n // 4
    return np.where(i < 4 * nv, (i // 4) % t, i - 4 * nv)


def _split(words, plan):
    """make_list: three quarters of the words as each thread's slots, the
    rest the spill: (slots a thread, spill words)."""
    slots = words * 3 // 4 // plan.threads
    return slots, words - slots * plan.threads


def _first_slots(thread, keep, slots):
    """Of the kept elements (in index order), those in their thread's first
    ``slots``: the rest spill."""
    idx = np.nonzero(keep)[0]
    th = thread[idx]
    order = np.argsort(th, kind="stable")
    first = np.searchsorted(th[order], th[order], side="left")
    rank = np.empty(len(idx), np.int64)
    rank[order] = np.arange(len(idx)) - first
    mine = np.zeros(len(keep), bool)
    mine[idx[rank < slots]] = True
    return mine


def model_row(bits, rank, c, plan, vec=True, fault=None, paths=None):
    """(statistic bits, max, sum) of one row of uint32 bit patterns as the
    kernel computes them with a cluster of ``c`` CTAs; ``paths`` collects
    the paths taken."""
    n = len(bits)
    r = rank_of(rank, n)
    seg = seg_len(n, c)
    resident = seg <= plan.hold
    hold_cap = plan.hold if resident else plan.stream_hold
    segs = [bits[min(k * seg, n):min(k * seg + seg, n)] for k in range(c)]
    held = [min(len(x), hold_cap) for x in segs]
    nb0, sh0 = 1 << plan.first_bits, 32 - plan.first_bits
    nb1 = 1 << plan.rest_bits
    paths = paths if paths is not None else set()

    def hist(x, shift, nb):
        return np.bincount((x >> np.uint32(shift)) & np.uint32(nb - 1),
                           minlength=nb).astype(np.int64)

    hists = [hist(x[:h], sh0, nb0) for x, h in zip(segs, held)]
    ring = plan.pipe * plan.threads * 4  # a longer row's stream staging
    wins = [(np.zeros(0, np.uint32), np.zeros(0, np.int64),
             np.zeros(0, bool)) for _ in segs]
    sums = [_thread_sums([x[:h], x[h:]], plan, vec) for x, h in zip(segs, held)]
    from_global = [False] * c
    if not resident:
        paths.add("window")
        big_h = sum(held)
        est = r * big_h // n
        delta = big_h // plan.window_div + plan.window_pad
        lo, hi = max(est - delta, 0), min(est + delta, big_h - 1)
        merged = sum(hists)
        win_lo = select(merged, lo, plan.coarse)[0]
        win_hi = select(merged, hi, plan.coarse)[0]
        for k, (x, h) in enumerate(zip(segs, held)):
            rest = x[h:]
            bins = rest >> np.uint32(sh0)
            inwin = (bins >= win_lo) & (bins <= win_hi)
            thread = _stream_threads(len(rest), plan, vec)
            slots, spill_cap = _split(plan.pool - h - ring, plan)
            mine = _first_slots(thread, inwin, slots)
            # the window's elements, their threads, and whether each is in
            # its thread's own slots (else in the spill)
            wins[k] = (rest[inwin], thread[inwin], mine[inwin])
            h1 = hists[k] + np.bincount(bins[inwin], minlength=nb0)
            if win_lo > 0:
                h1[win_lo - 1] += int((bins < win_lo).sum())
            if win_hi < nb0 - 1:
                h1[win_hi + 1] += int((bins > win_hi).sum())
            hists[k] = h1
            if int(inwin.sum()) - int(mine.sum()) > spill_cap:
                from_global[k] = True
                paths.add("overflow")
    digit, r = select(sum(hists), r, plan.coarse)
    if not resident and not win_lo <= digit <= win_hi:
        paths.add("miss")
        from_global = [True] * c
        digit, r = select(sum(hist(x, sh0, nb0) for x in segs), rank_of(
            rank, n), plan.coarse)
    prefix = np.uint32(digit << sh0)
    fixed = np.uint32((nb0 - 1) << sh0)
    # Digit 1 counts over the held part and the window's candidates (or the
    # re-read segment) and keeps the chosen bin's elements: each thread's in
    # its own slots, the window spill's matches straight in the spill;
    # digit 2 counts over that list if its spill fits.
    sources, lists2, fits = [], [], []
    for k, (x, h) in enumerate(zip(segs, held)):
        if from_global[k]:
            sources.append(x)
            lists2.append(None)
            fits.append(False)
            continue
        welems, wthread, wmine = wins[k]
        src = np.concatenate([x[:h], welems])
        match = (src & fixed) == prefix
        thread = np.concatenate([_held_threads(h, plan), wthread])
        own = np.concatenate([np.ones(h, bool), wmine])
        words = plan.pool - h if resident else ring
        slots, spill_cap = _split(words, plan)
        per_thread = np.bincount(thread[match & own], minlength=plan.threads)
        spilled = int(np.maximum(per_thread - slots, 0).sum()) + int(
            (match & ~own).sum())
        sources.append(src)
        lists2.append(src[match])
        fits.append(spilled <= spill_cap)
    if fault == "drop_last":  # the compaction loses the bin's last element
        lists2 = [lst[:-1] if lst is not None and len(lst) else lst
                  for lst in lists2]
    for d, shift in ((1, plan.rest_bits), (2, 0)):
        counts = np.zeros(nb1, np.int64)
        for k in range(c):
            if d == 2 and fits[k]:
                src = lists2[k]
            else:
                src = sources[k]
                if d == 2 and not from_global[k]:
                    paths.add("rescan")
            src = src[(src & fixed) == prefix]
            counts += hist(src, shift, nb1)
        digit, r = select(counts, r, plan.coarse)
        prefix |= np.uint32(digit << shift)
        fixed |= np.uint32((nb1 - 1) << shift)
    paths.add("resident" if resident else "longer")
    total = 0.0
    for acc in sums:
        total += _cta_sum(acc, plan)
    mx = max((float(x.view(np.float32).max()) for x in segs if len(x)),
             default=0.0)
    return int(prefix), np.float32(mx), np.float32(total)


def rank_of(rank, n):
    return min(max(int(rank), 0), n - 1)


def model(x2d, ranks, plan=KERNEL, active=ACTIVE, fault=None, paths=None):
    """The kernel over an (L, n) float32 array: (L,) statistics, maxima and
    sums. Rows start 16-byte aligned when n is a multiple of 4 (or L = 1),
    as torch's allocations do."""
    lead, n = x2d.shape
    c, _ = cluster_plan(n, lead, plan, active)
    out = []
    for i in range(lead):
        vec = (i * n) % 4 == 0
        s, m, t = model_row(x2d[i].view(np.uint32), ranks[i], c, plan, vec,
                            fault, paths)
        out.append((np.uint32(s).view(np.float32), m, t))
    return [np.asarray(v, np.float32) for v in zip(*out)]


def _row(kind, n, rng):
    if kind == "randn":
        return np.abs(rng.randn(n)).astype(np.float32)
    if kind == "dups":
        return (rng.randint(0, 6, n) / 4.0).astype(np.float32)
    if kind == "zeros":
        return np.zeros(n, np.float32)
    if kind == "equal":
        return np.full(n, 0.37, np.float32)
    if kind == "bin90":  # > 90 % in one digit-0 bin
        x = np.full(n, 1.5, np.float32)
        few = rng.rand(n) < 0.05
        x[few] = (rng.rand(int(few.sum())) * 100).astype(np.float32)
        return x
    if kind == "subnormal":  # exact zeros and subnormals among normals
        x = np.abs(rng.randn(n)).astype(np.float32)
        u = rng.rand(n)
        x[u < 0.3] = 0.0
        sub = (u >= 0.3) & (u < 0.6)
        x[sub] = (x[sub] * 1e-40).astype(np.float32)
        return x
    if kind == "sorted":  # the held sample is not the row: the window misses
        return np.sort(np.abs(rng.randn(n)).astype(np.float32))
    raise ValueError(kind)


KINDS = ("randn", "dups", "zeros", "equal", "bin90", "subnormal", "sorted")


def _ranks(n):
    return sorted({0, 1 % n, int(np.floor(np.float32(0.3) * np.float32(n))),
                   n - 1})


def _check(x2d, ranks, stat, mx, sm, what):
    srt = np.sort(x2d, axis=1)
    want = srt[np.arange(len(ranks)), ranks]
    assert stat.view(np.uint32).tolist() == want.view(np.uint32).tolist(), \
        what
    assert mx.tolist() == x2d.max(axis=1).tolist(), what
    ref = x2d.astype(np.float64).sum(axis=1)
    assert np.all(np.abs(sm - ref) <= 1e-6 * np.abs(ref)), what


def _cases(plan, sizes, fault=None, paths=None):
    rng = np.random.RandomState(0)
    for n in sizes:
        for kind in KINDS:
            x = _row(kind, n, rng)[None]
            for r in _ranks(n):
                ranks = np.asarray([r], np.int32)
                got = model(x, ranks, plan, fault=fault, paths=paths)
                _check(x, ranks, *got, (plan.threads, kind, n, r))


# The kernel's own constants: resident rows of one CTA (n <= 45,056 here),
# including the sizes of the retrieval tower that stay in one CTA.
KERNEL_SIZES = (1, 5, 1000, 16384, 16385, 18432, 36864)
# The scaled-down plan: clusters of 1-16 resident CTAs, longer rows through
# the window (and its misses and overflows).
SMALL_SIZES = (3, 1000, 2001, 9000, 20000, 60000)


def test_model_bit_exact_vs_sort_at_kernel_constants():
    paths = set()
    _cases(KERNEL, KERNEL_SIZES, paths=paths)
    assert paths == {"resident", "rescan"}, paths


def test_model_bit_exact_vs_sort_on_every_path():
    paths = set()
    _cases(SMALL, SMALL_SIZES, paths=paths)
    assert {"resident", "longer", "window", "miss", "overflow",
            "rescan"} <= paths, paths


@pytest.mark.parametrize("plan,sizes", [(KERNEL, KERNEL_SIZES),
                                        (SMALL, SMALL_SIZES)],
                         ids=["kernel", "small"])
def test_planted_compaction_fault_fails_the_checks(plan, sizes):
    with pytest.raises(AssertionError):
        _cases(plan, sizes, fault="drop_last")


@pytest.mark.parametrize("lead,n,plan", [(13, 2001, SMALL), (3, 9000, SMALL),
                                         (1, 60000, SMALL),
                                         (13, 1000, KERNEL)],
                         ids=["L13", "L3", "L1", "L13-kernel"])
def test_model_batched_rows_bit_exact_vs_sort(lead, n, plan):
    rng = np.random.RandomState(lead)
    x = np.stack([_row(KINDS[i % len(KINDS)], n, rng) for i in range(lead)])
    picks = [0, n - 1, int(np.floor(np.float32(0.3) * np.float32(n))), 1]
    ranks = np.asarray([picks[i % 4] for i in range(lead)], np.int32)
    _check(x, ranks, *model(x, ranks, plan), (lead, n))


def test_main_path_plans():
    """The launch plans of the shapes the main paths give the kernel, on a
    card with ACTIVE's clusters."""
    assert cluster_plan(401408, 1, KERNEL) == (16, True)
    for n in (18432, 36864):
        assert cluster_plan(n, 1, KERNEL) == (1, True)
    assert cluster_plan(73728, 1, KERNEL) == (2, True)
    assert cluster_plan(98304, 1, KERNEL) == (4, True)
    assert cluster_plan(589824, 12, KERNEL) == (8, False)
    assert cluster_plan(2359296, 12, KERNEL) == (8, False)
    assert cluster_plan(2359296, 1, KERNEL) == (16, False)


def test_sum_is_fixed_order_and_within_1e6():
    rng = np.random.RandomState(3)
    x = np.stack([_row("randn", 20000, rng), _row("equal", 20000, rng)])
    ranks = np.asarray([5, 7], np.int32)
    a = model(x, ranks, SMALL)[2]
    b = model(x, ranks, SMALL)[2]
    assert a.tobytes() == b.tobytes()
    ref = x.astype(np.float64).sum(axis=1)
    np.testing.assert_allclose(a, ref, rtol=1e-6)


@pytest.mark.parametrize("kind,n", [("randn", 1000), ("dups", 16385),
                                    ("subnormal", 9000)])
def test_model_bit_exact_vs_jax_kernel(monkeypatch, kind, n):
    from atq_tpu.ops.order_stat import order_statistic_reductions

    monkeypatch.setenv("ATQ_PALLAS_INTERPRET", "1")
    x = _row(kind, n, np.random.RandomState(n))
    plan = SMALL if n == 9000 else KERNEL
    for r in _ranks(n):
        got = model(x[None], np.asarray([r], np.int32), plan)
        want = order_statistic_reductions(jnp.asarray(x), jnp.int32(r))
        assert got[0].tobytes() == np.asarray(want[0]).reshape(1).tobytes()
        assert got[1].tobytes() == np.asarray(want[1]).reshape(1).tobytes()
        np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=1e-6)


@pytest.mark.parametrize("lead,n,plan", [(3, 16385, KERNEL),
                                         (4, 9000, SMALL)],
                         ids=["L3-kernel", "L4-small"])
def test_model_batched_bit_exact_vs_jax_kernel(monkeypatch, lead, n, plan):
    from atq_tpu.ops.order_stat import order_statistic_reductions_batched

    monkeypatch.setenv("ATQ_PALLAS_INTERPRET", "1")
    rng = np.random.RandomState(lead)
    x = np.stack([_row(("randn", "dups", "sorted", "bin90")[i % 4], n, rng)
                  for i in range(lead)])
    picks = [0, n - 1, int(np.floor(np.float32(0.3) * np.float32(n))), 1]
    ranks = np.asarray([picks[i % 4] for i in range(lead)], np.int32)
    got = model(x, ranks, plan)
    want = order_statistic_reductions_batched(jnp.asarray(x),
                                              jnp.asarray(ranks))
    assert got[0].tobytes() == np.asarray(want[0]).tobytes()
    assert got[1].tobytes() == np.asarray(want[1]).tobytes()
    np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=1e-6)
