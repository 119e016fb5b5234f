"""Port parity for ``repro_torch.kvcache.shortcut_cache`` against
``repro.kvcache.shortcut_cache``: on the same sync prefill / append / release
/ pump trace, for 1, 2 and 4 shards, the stacked views, ``get_context`` on
both routes, the route gate and counters, fragmentation and maintenance stats
are identical.  The functional entry points (``compose_seq``,
``append_to_view``, ``slice_context``, ``stacked_context``) are held to the
JAX ones, and an async test races readers against the mapper threads'
copy-on-write publishes."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kvcache import paged_cache as jpc
from repro.kvcache import shortcut_cache as jsc
from repro_torch.convert import (kv_view_from_numpy, kv_view_to_numpy,
                                 paged_cache_from_numpy)
from repro_torch.kvcache import paged_cache as tpc
from repro_torch.kvcache import shortcut_cache as tsc

L, BS, KV, HD = 2, 4, 2, 8
MAX_SEQS, CAP = 8, 32


def make_pair(num_shards, **kw):
    args = (L, MAX_SEQS * (CAP // BS) * 2, BS, KV, HD, MAX_SEQS, CAP // BS)
    j = jsc.ShortcutKVManager(jpc.cache_create(*args, dtype=jnp.float32),
                              seq_capacity=CAP, num_shards=num_shards, **kw)
    t = tsc.ShortcutKVManager(
        tpc.cache_create(*args, dtype=torch.float32, device="cpu"),
        seq_capacity=CAP, num_shards=num_shards, device="cpu", **kw)
    return j, t


def draw(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def observe(m):
    return dict(stats=[(s.creates, s.updates, s.collapsed, s.slots_remapped)
                       for s in m.group.per_shard_stats()],
                routes=(m.routed_shortcut, m.routed_paged,
                        [(g.routed_shortcut, g.routed_fallback)
                         for g in m.group]),
                versions=[dict(g._trad) for g in m.group],
                sc=[dict(g._sc) for g in m.group],
                epochs=[(g.trad_epoch, g.view_epoch) for g in m.group],
                cache_epochs=m.operands.epochs("kv_view"))


def assert_same(j, t, ids):
    for a, b in zip(j.operands.handle("kv_view"),
                    kv_view_to_numpy(t.operands.handle("kv_view"))):
        np.testing.assert_array_equal(np.asarray(a), b)
    for f, a, b in zip(jpc.PagedKVCache._fields, j.cache, t.cache):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)
    if len(ids):
        assert j.in_sync(ids) == t.in_sync(ids)
        assert j.fragmentation(ids) == t.fragmentation(ids)
        assert j.route(ids) == t.route(ids)
        for route in ("paged", "shortcut"):
            jk, jv, jr = j.get_context(ids, route=route)
            tk, tv, tr = t.get_context(ids, route=route)
            assert jr == tr
            np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
            np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        jk, _, jr = j.get_context(ids)
        tk, _, tr = t.get_context(ids)
        assert jr == tr
        np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    assert observe(j) == observe(t)


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_sync_trace(num_shards):
    rng = np.random.default_rng(num_shards)
    j, t = make_pair(num_shards)
    active: dict = {}
    for step in range(24):
        op = ["prefill", "append", "append", "pump", "release",
              "append"][step % 6]
        if op == "prefill":
            free = [s for s in range(MAX_SEQS) if s not in active]
            ids = rng.choice(free, size=min(2, len(free)), replace=False)
            S = int(rng.choice([BS, 2 * BS, 3 * BS]))
            jk, tk = draw(rng, L, ids.size, S, KV, HD)
            j.prefill(ids, jk, -jk)
            t.prefill(ids, tk, -tk)
            active.update({int(s): S for s in ids})
        elif op == "append":
            ids = np.asarray(sorted(s for s, n in active.items()
                                    if n < CAP - 1))
            if ids.size:
                jk, tk = draw(rng, L, ids.size, KV, HD)
                j.append(ids, jk, 2 * jk)
                t.append(ids, tk, 2 * tk)
                for s in ids.tolist():
                    active[s] += 1
        elif op == "release" and len(active) > 2:
            s = int(rng.choice(sorted(active)))
            j.release(np.array([s]))
            t.release(np.array([s]))
            del active[s]
        else:
            assert j.pump() == t.pump()
        ids = np.asarray(sorted(active))
        rng.shuffle(ids)
        assert_same(j, t, ids)
    j.pump()
    t.pump()
    assert_same(j, t, np.asarray(sorted(active)))
    j.close()
    t.close()


def test_routes_follow_fragmentation_and_release():
    """The scenarios of ``tests/test_kvcache.py``: a fresh contiguous
    prefill routes paged, a fragmented in-sync batch shortcut, a released
    sequence paged again, an empty batch touches nothing."""
    rng = np.random.default_rng(7)
    j, t = make_pair(1)
    jk, tk = draw(rng, L, 1, 8, KV, HD)
    for m, k in ((j, jk), (t, tk)):
        m.prefill(np.array([0]), k, k)
        m.pump()
        assert m.route(np.array([0])) == "paged"
    jp, tp = draw(rng, L, 1, 4, KV, HD)
    jk, tk = draw(rng, L, 2, KV, HD)
    for m, p, k in ((j, jp, jk), (t, tp, tk)):  # blocks of 0 and 1 interleave
        m.prefill(np.array([1]), p, p)
        for _ in range(6):
            m.append(np.array([0, 1]), k, k)
        m.pump()
    ids = np.array([0, 1])
    assert t.route(ids) == j.route(ids) == "shortcut"
    assert_same(j, t, ids)
    for m in (j, t):
        m.release(np.array([0]))
        assert m.route(ids) == "paged" and not m.in_sync(ids)
        k, v, r = m.get_context(np.array([], np.int64))
        assert r == "paged" and k.shape == (L, 0, KV, CAP, HD)
    assert observe(j) == observe(t)


def test_functional_entry_points():
    rng = np.random.default_rng(3)
    args = (L, 16, BS, KV, HD, 3, 4)
    jc = jpc.cache_create(*args, dtype=jnp.float32)
    jk, tk = draw(rng, L, 3, 12, KV, HD)
    jc = jpc.write_prefill(jc, jnp.asarray([0, 1, 2]), jk, -jk)
    jc = jpc.release_seqs(jc, jnp.asarray([1]))
    jn, tn = draw(rng, L, 2, KV, HD)
    jc = jpc.append_tokens(jc, jnp.asarray([0, 2]), jn, jn)
    tc = paged_cache_from_numpy(jc, device="cpu")
    jv = jnp.asarray(rng.standard_normal((L, 2, 16, KV, HD)).astype(
        np.float32))
    tv, tv_neg = kv_view_from_numpy((jv, -jv), device="cpu")
    assert torch.equal(tv_neg, -tv)
    for seq, row in ((0, 0), (1, 1), (2, 1)):
        want = jsc.compose_seq(jc, jv, -jv, jnp.int32(seq), jnp.int32(row))
        got = tsc.compose_seq(tc, tv, -tv, seq, row)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert not torch.equal(got[0], tv), "the input view was written"
    want = jsc.append_to_view(jv, -jv, jnp.asarray([1, 0]),
                              jnp.asarray([3, 15]), jn, 2 * jn)
    got = tsc.append_to_view(tv, -tv, np.array([1, 0]), np.array([3, 15]),
                             tn, 2 * tn)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jsc.slice_context(jv, -jv, jnp.asarray([1, 0, 1])),
                    tsc.slice_context(tv, -tv, [1, 0, 1])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    js = jnp.stack([jv, 2 * jv])
    ts = torch.stack([tv, 2 * tv])
    for a, b in zip(jsc.stacked_context(js, -js, jnp.asarray([1, 0, 1]),
                                        jnp.asarray([0, 1, 1])),
                    tsc.stacked_context(ts, -ts, [1, 0, 1], [0, 1, 1])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("num_shards", [2, 4])
def test_async_readers_race_publishes(num_shards):
    """Mapper threads replay while the main thread appends and a reader
    thread snapshots each shard: every (view_k, view_v) pair it sees is
    from one publication (v == -k), and the settled views equal those of a
    single-shard manager given the same trace."""
    rng = np.random.default_rng(11)
    _, one = make_pair(1)
    _, many = make_pair(num_shards, async_mapper=True, poll_interval=0.002)
    tears, stop = [], threading.Event()

    def reader():
        while not stop.is_set():
            for s in range(num_shards):
                vk, vv = many.views.snapshot(s)
                if not torch.equal(vv, -vk):
                    tears.append(s)
                    return

    thread = threading.Thread(target=reader, daemon=True)
    thread.start()
    ids = np.arange(MAX_SEQS)
    try:
        _, k = draw(rng, L, MAX_SEQS, 2 * BS, KV, HD)
        for m in (one, many):
            m.prefill(ids, k, -k)
        for _ in range(10):
            _, k = draw(rng, L, MAX_SEQS, KV, HD)
            for m in (one, many):
                m.append(ids, k, -k)
        one.pump()
        assert many.wait_in_sync(ids, timeout=60.0)
        a = one.get_context(ids, route="shortcut")
        b = many.get_context(ids, route="shortcut")
        for x, y in zip(a[:2], b[:2]):
            assert torch.equal(x, y)
    finally:
        stop.set()
        thread.join(timeout=10.0)
        one.close()
        many.close()
    assert not tears, f"torn view pair on shards {tears}"


def test_manager_checks_its_device():
    cache = tpc.cache_create(1, 4, 2, 1, 8, 2, 2, device="cpu")
    with pytest.raises(ValueError):
        tsc.ShortcutKVManager(cache, 4, device="meta")
