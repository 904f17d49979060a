"""The port's host bookkeeping (page allocator, scheduler, prefix index,
device loop state) under the reference's own unit tests, seeded traces
from both packages, and the port's Engine against the JAX Engine."""

import numpy as np
import pytest

from _torch_parity import assert_engines_agree, traces
from repro_torch.configs import get_config
from repro_torch.runtime import (NEUTRAL_OWNER, DeviceLoopState,
                                 MultiQueueScheduler, PageAllocator,
                                 PagerConfig, PrefixIndex, Request, Scheduler)

# --- kv_pager (test_runtime.py's allocator tests, over the port's class) ----------


def test_allocator_conservation():
    a = PageAllocator(17)
    assert a.free_count == 16 and a.live_count == 0
    p1 = a.alloc(1, 5)
    p2 = a.alloc(2, 7)
    assert len(p1) == 5 and len(p2) == 7
    assert not set(p1) & set(p2), "pages double-allocated"
    assert 0 not in p1 + p2, "trash page handed out"
    assert a.live_count == 12 and a.free_count == 4
    a.check()
    assert a.alloc(3, 5) is None            # insufficient: no change
    assert a.free_count == 4
    a.check()
    assert a.free_owner(1) == 5
    with pytest.raises(ValueError):         # double-free raises
        a.free_owner(1)
    assert a.free_count == 9
    p3 = a.alloc(3, 9)
    assert len(p3) == 9 and not set(p3) & set(p2)
    a.check()
    a.free_owner(2)
    a.free_owner(3)
    assert a.free_count == 16 and a.live_count == 0
    a.check()


def test_allocator_check_catches_corruption():
    a = PageAllocator(9)
    a.alloc(1, 3)
    a._owned[2] = [a._owned[1][0]]          # fake a double ownership
    with pytest.raises(AssertionError):
        a.check()


def test_allocator_limit_resize():
    a = PageAllocator(9, limit=4)
    a.alloc(1, 3)
    with pytest.raises(AssertionError):
        a.set_limit(2)                      # below the live count
    a.set_limit(8)
    assert a.free_count == 5
    a.free_owner(1)
    a.check()


def test_pager_config_geometry():
    p = PagerConfig(num_pages=9, page_size=16, max_pages_per_seq=4)
    assert p.max_context == 64
    assert p.pages_for(1) == 1 and p.pages_for(16) == 1
    assert p.pages_for(17) == 2 and p.pages_for(64) == 4
    assert p.steps_to_boundary(16) == 16 and p.steps_to_boundary(17) == 15
    cfg = get_config("codeqwen1.5-7b").reduced()
    assert p.page_bytes(cfg) == (2 * cfg.num_layers * 16
                                 * cfg.num_kv_heads * cfg.head_dim * 2)


def test_allocator_share_guards_and_reclaimable_accounting():
    a = PageAllocator(9, limit=8)
    pages = a.alloc(1, 3)
    a.share(2, pages[:2])
    assert a.refcount(pages[0]) == 2
    assert a.shared_count == 2
    with pytest.raises(ValueError):
        a.share(2, pages[:1])               # already held by 2
    with pytest.raises(ValueError):
        a.share(3, [pages[0], pages[0]])    # duplicate in one call
    with pytest.raises(ValueError):
        a.share(3, [0])                     # not a live page
    a.free_owner(1)         # drops refs; the shared rows stay live
    assert a.live_count == 2
    with pytest.raises(ValueError):
        a.free_page(1, pages[0])            # 1 no longer holds it
    a.share(NEUTRAL_OWNER, pages[:2])
    assert a.neutral_count == 0             # still demanded by owner 2
    assert a.demand_count == 2
    a.free_owner(2)
    assert a.neutral_count == 2             # index-only: reclaimable
    assert a.demand_count == 0
    a.free_owner(NEUTRAL_OWNER)
    assert a.live_count == 0
    a.check()


def test_allocator_cow_copies_exactly_one_page():
    a = PageAllocator(17, limit=16)
    row = a.alloc(1, 4)
    a.share(NEUTRAL_OWNER, row)             # index pins the row
    a.share(2, row)                         # a twin maps it too
    live0 = a.live_count
    target = row[2]
    new = a.alloc(1, 1)[0]                  # CoW by owner 1
    a.free_page(1, target)
    assert a.live_count == live0 + 1
    assert a.refcount(target) == 2 and a.refcount(new) == 1
    assert sorted(a.owned(2)) == sorted(row)
    assert sorted(a.owned(NEUTRAL_OWNER)) == sorted(row)
    assert sorted(a.owned(1)) \
        == sorted([*(p for p in row if p != target), new])
    a.check()


def test_allocator_refcount_conservation_walk():
    """Seeded random walk over alloc/share/free_page/free_owner against a
    holder model."""
    rng = np.random.default_rng(0)
    a = PageAllocator(17, limit=12)
    owners = tuple(range(1, 6))
    model, held = {}, {o: [] for o in owners}
    for _ in range(300):
        kind = int(rng.integers(0, 4))
        o = owners[int(rng.integers(len(owners)))]
        if kind == 0:
            want = int(rng.integers(1, 4))
            if a.can_alloc(want):
                for p in a.alloc(o, want):
                    assert p not in model   # live pages never reused
                    model[p] = {o}
                    held[o].append(p)
        elif kind == 1:
            src = owners[int(rng.integers(len(owners)))]
            cand = [p for p in held[src] if o not in model[p]]
            if cand:
                p = cand[int(rng.integers(len(cand)))]
                a.share(o, [p])
                model[p].add(o)
                held[o].append(p)
        elif kind == 2 and held[o]:
            p = held[o].pop(int(rng.integers(len(held[o]))))
            a.free_page(o, p)
            model[p].discard(o)
            if not model[p]:
                del model[p]
        elif kind == 3:
            if held[o]:
                a.free_owner(o)
                for p in held[o]:
                    model[p].discard(o)
                    if not model[p]:
                        del model[p]
                held[o] = []
            else:                           # double-free raises
                with pytest.raises(ValueError):
                    a.free_owner(o)
        a.check()
        assert a.live_count == len(model)
        assert a.shared_count == sum(len(h) >= 2 for h in model.values())
        for p, holders in model.items():
            assert a.refcount(p) == len(holders)


# --- scheduler and prefix index ---------------------------------------------------


def _req(rid, arrival, admitted=-1):
    r = Request(rid=rid, prompt=np.zeros(4, np.int32), max_new_tokens=4,
                arrival=arrival)
    r.admitted_step = admitted
    return r


def test_scheduler_arrival_release_and_requeue():
    s = Scheduler([_req(0, 5), _req(1, 0), _req(2, 3)])
    s.release_arrivals(0)
    assert s.peek_ready().rid == 1
    assert s.next_arrival() == 3
    s.release_arrivals(4)
    assert [s.pop_ready().rid for _ in range(2)] == [1, 2]
    s.release_arrivals(5)
    preempted = s.pop_ready()
    assert preempted.rid == 0
    s.requeue(preempted)                    # preempted keeps queue priority
    assert s.peek_ready().rid == 0
    assert s.preemptions == 1


def test_scheduler_picks_latest_admitted_victim():
    active = [(0, _req(0, 0, admitted=2)), (1, _req(1, 0, admitted=9)),
              (2, _req(2, 0, admitted=5))]
    slot, req = Scheduler.pick_victim(active)
    assert (slot, req.rid) == (1, 1)
    slot, req = Scheduler.pick_victim(active, exclude=1)
    assert (slot, req.rid) == (2, 2)
    slot, req = Scheduler.pick_victim([active[0]], exclude=0)
    assert slot == 0                        # falls back to the requester


def test_multi_queue_scheduler_oldest_ready_arrival():
    def mk(rid, arr, m):
        return Request(rid=rid, prompt=np.zeros(4, np.int32),
                       max_new_tokens=4, arrival=arr, model_id=m)
    s = MultiQueueScheduler([mk(0, 2, "a"), mk(1, 5, "b"), mk(2, 9, "a")])
    assert s.oldest_ready_arrival() is None
    s.release_arrivals(6)
    assert s.oldest_ready_arrival() == 2    # head of a's queue
    head = s.peek_ready(["a"])
    assert s.pop_ready(head).rid == 0
    assert s.oldest_ready_arrival() == 5    # b's head is now oldest
    s.release_arrivals(9)
    assert s.oldest_ready_arrival() == 5


def test_prefix_index_match_insert_evict_lru():
    a = PageAllocator(17, limit=12)
    idx = PrefixIndex(4)
    toks = [1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3]
    row = a.alloc(7, 3)
    assert idx.insert(a, toks, row) == 3
    assert all(a.refcount(p) == 2 for p in row)
    pages, covered = idx.match([1, 1, 1, 1, 2, 2, 2, 2, 9])
    assert pages == row[:2] and covered == 8
    pages, covered = idx.match([1, 1, 1, 1, 2, 2, 2, 2, 3, 3],
                               allow_tail=True)
    assert pages == row and covered == 10
    row_b = a.alloc(8, 3)
    assert idx.insert(a, toks, row_b) == 0  # dedup
    a.free_owner(8)
    a.free_owner(7)
    assert a.neutral_count == 3 and a.demand_count == 0
    assert idx.evict_lru(a, 2) == 2
    pages, covered = idx.match(toks)
    assert covered == 4                     # only the root chunk left
    assert idx.release_all(a) == 1
    assert a.live_count == 0
    a.check()


# --- traces and device loop state --------------------------------------------------


@pytest.mark.parametrize("kind,kw", [
    ("poisson_trace", dict(n_requests=12, mean_interarrival=0.3,
                           prompt_lens=(6, 10), gen_lens=(3, 6, 24), seed=5)),
    ("shared_prefix_trace", dict(n_requests=10, overlap=0.5, prompt_len=32,
                                 mean_interarrival=0.25, gen_lens=(8, 16),
                                 seed=11, resend_frac=0.5)),
])
def test_seeded_traces_identical_across_packages(kind, kw):
    jt, tt = traces(kind, vocab_size=256, **kw)
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        assert (a.rid, a.arrival, a.max_new_tokens, a.model_id) == \
            (b.rid, b.arrival, b.max_new_tokens, b.model_id)
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_device_loop_state_syncs_dirty_rows_padded():
    ds = DeviceLoopState(5, 3, "cpu")
    table = np.arange(15, dtype=np.int32).reshape(5, 3)
    vec = np.arange(5, dtype=np.int32)
    ds.sync(table, vec, vec + 10, vec + 20)         # all 5 rows: width 8
    assert ds.page_table_upload_bytes == 8 * 3 * 4
    np.testing.assert_array_equal(ds.table.numpy(), table)
    table[1] = 99
    vec[3] = 77
    ds.touch(1)
    ds.touch(3)
    ds.sync(table, vec, vec + 10, vec + 20)         # 2 rows: width 2
    assert ds.page_table_upload_bytes == (8 + 2) * 3 * 4
    assert ds.device_dispatches == 2
    np.testing.assert_array_equal(ds.table.numpy(), table)
    np.testing.assert_array_equal(ds.lengths.numpy(), vec)
    np.testing.assert_array_equal(ds.remaining.numpy(), vec + 20)
    ds.sync(table, vec, vec, vec)                   # nothing dirty
    assert ds.device_dispatches == 2


# --- the engine against the JAX engine -----------------------------------------------


def test_engine_matches_jax_engine_with_preemption():
    """Page-starved pool, fused horizons of 32: equal ledgers (including
    preemptions and dispatch/sync counts) and consistent tokens."""
    jrep, trep = assert_engines_agree(
        "poisson_trace", dict(n_requests=8, mean_interarrival=0.2,
                              prompt_lens=(8, 16), gen_lens=(24, 40),
                              seed=1),
        num_slots=4, page_size=8, num_pages=17, max_pages_per_seq=8,
        prefill_bucket=8)
    assert trep.preemptions > 0
    assert trep.host_syncs < trep.decode_steps      # fused horizons ran
