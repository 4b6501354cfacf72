"""Page allocator of the PyTorch port vs the JAX package's: ``PageAllocator``,
``SlotPages`` and ``pages_for`` driven through one seeded random sequence of
alloc/free/fork must keep equal free lists and refcounts, and raise the
same errors on misuse."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serve import paged as jpaged  # noqa: E402
from repro_torch.obs import MetricsRegistry, Tracer  # noqa: E402
from repro_torch.serve import paged as tpaged  # noqa: E402


def _state(a):
    return list(a._free), a._refs.tolist(), a.num_free, a.live_pages


def test_random_sequence_matches_reference():
    rng = np.random.default_rng(0)
    ja, ta = jpaged.PageAllocator(17, 4), tpaged.PageAllocator(17, 4)
    owned = []                              # page lists held by "owners"
    for _ in range(400):
        op = rng.choice(["alloc", "free", "fork"])
        if op == "alloc":
            n = int(rng.integers(0, 6))
            assert ja.can_alloc(n) == ta.can_alloc(n)
            jp, tp = ja.alloc(n), ta.alloc(n)
            assert jp == tp
            if tp is not None:
                owned.append(tp)
        elif owned and op == "free":
            pages = owned.pop(int(rng.integers(len(owned))))
            ja.free(pages)
            ta.free(pages)
        elif owned:
            pages = owned[int(rng.integers(len(owned)))]
            assert ja.fork(pages) == ta.fork(pages)
            owned.append(list(pages))
        assert _state(ja) == _state(ta)
        ta.assert_consistent()
        for p in range(17):
            assert ja.ref_count(p) == ta.ref_count(p)
    for pages in owned:
        ta.free(pages)
    assert ta.live_pages == 0
    ta.assert_consistent()


@pytest.mark.parametrize("case", ["double_free", "double_in_one_call",
                                  "free_trash", "fork_trash", "fork_freed",
                                  "out_of_range", "negative"])
def test_misuse_raises_like_reference(case):
    errs = []
    for mod in (jpaged, tpaged):
        a = mod.PageAllocator(6, 2)
        p = a.alloc(2)
        before = (list(a._free), a._refs.tolist())
        call = {"double_free": lambda: (a.free(p), a.free(p)),
                "double_in_one_call": lambda: a.free([p[0], p[0]]),
                "free_trash": lambda: a.free([0]),
                "fork_trash": lambda: a.fork([0, p[0]]),
                "fork_freed": lambda: (a.free([p[1]]), a.fork([p[1]])),
                "out_of_range": lambda: a.free([6]),
                "negative": lambda: a.fork([-1])}[case]
        with pytest.raises(ValueError) as e:
            call()
        if case in ("double_in_one_call", "free_trash", "fork_trash",
                    "out_of_range", "negative"):      # all-or-nothing
            assert (list(a._free), a._refs.tolist()) == before
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_constructor_checks_slot_pages_and_pages_for():
    for mod in (jpaged, tpaged):
        with pytest.raises(ValueError, match="trash page"):
            mod.PageAllocator(1, 4)
        with pytest.raises(ValueError, match="page_size"):
            mod.PageAllocator(4, 0)
    for n in range(0, 40):
        for ps in (1, 4, 16):
            assert tpaged.pages_for(n, ps) == jpaged.pages_for(n, ps)
    assert tpaged.pages_for(-3, 4) == 0
    for pages, new_len in (([3, 1], 8), ([3, 1], 9), ([], 1), ([5], 0)):
        js, ts = jpaged.SlotPages(4, list(pages)), tpaged.SlotPages(
            4, list(pages))
        assert ts.pages_needed(new_len) == js.pages_needed(new_len)
        row = ts.table_row(5)
        assert row.dtype == np.int32
        np.testing.assert_array_equal(row, js.table_row(5))
    # fault injection is ported (it was a later slice): the allocator
    # takes an injector and consults it on alloc
    from repro_torch.serve.faults import Fault, FaultInjector, FaultPlan
    a = tpaged.PageAllocator(4, 4, faults=FaultInjector(FaultPlan((
        Fault("pool_dry"),))))
    assert a.alloc(1) is None and len(a.alloc(1)) == 1
    a.assert_consistent()


def test_metrics_and_spans():
    m, tr = MetricsRegistry(), Tracer()
    tr.enable()
    a = tpaged.PageAllocator(5, 4, metrics=m, tracer=tr)
    p = a.alloc(3)
    assert a.alloc(2) is None
    a.fork(p[:1])
    a.free(p)
    assert m.counter("pages.allocated").value == 3
    assert m.counter("pages.alloc_failures").value == 1
    assert m.counter("pages.forked").value == 1
    assert m.counter("pages.freed").value == 3
    assert m.gauge("pages.live").value == 1 == a.live_pages
    st = tr.self_times()
    assert st["pages.alloc"]["count"] == 2 and st["pages.free"]["count"] == 1
