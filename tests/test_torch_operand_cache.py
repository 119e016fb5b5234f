"""Port parity: ``repro_torch.runtime.operand_cache`` against
``repro.runtime.operand_cache``.  The reference's unit and publish-path
cases (``tests/test_operand_cache.py``) run against both caches with the
reference's expectations; the port-only cases pin its copy-on-write
publish: a handle or slice a reader holds never changes."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.operand_cache import StackedOperandCache as JCache
from repro_torch.runtime.operand_cache import StackedOperandCache as TCache


class _Jax:
    Cache = JCache

    @staticmethod
    def arr(a):
        return jnp.asarray(a)

    @staticmethod
    def npy(x):
        return np.asarray(x)

    @staticmethod
    def nbytes(x):
        return x.nbytes


class _Torch:
    Cache = TCache

    @staticmethod
    def arr(a):
        return torch.from_numpy(np.array(a))

    @staticmethod
    def npy(x):
        return x.numpy()

    @staticmethod
    def nbytes(x):
        return x.nbytes


@pytest.fixture(params=[_Jax, _Torch], ids=["jax", "torch"])
def P(request):
    return request.param


def _parts(P, data, calls=None):
    def parts(s):
        if calls is not None:
            calls.append(s)
        return tuple(P.arr(a) for a in data[s])
    return parts


# ---------------------------------------------------------------------------
# Unit semantics of the cache (the reference's TestCacheUnit).
# ---------------------------------------------------------------------------

class TestCacheUnit:
    def test_build_hit_and_dirty_refresh(self, P):
        cache = P.Cache(3)
        data = [(np.full((4,), s, np.int32), np.full((2, 2), s, np.float32))
                for s in range(3)]
        calls = []
        out = cache.get("fam", [0, 0, 0], _parts(P, data, calls))
        assert sorted(calls) == [0, 1, 2]
        assert cache.stats.rebuilds == 1
        np.testing.assert_array_equal(P.npy(out[0])[1], 1)
        calls.clear()
        out2 = cache.get("fam", [0, 0, 0], _parts(P, data, calls))
        assert calls == [] and cache.stats.hits == 1
        assert all(a is b for a, b in zip(out, out2))
        data[1] = (np.full((4,), 7, np.int32), np.full((2, 2), 7, np.float32))
        out3 = cache.get("fam", [0, 5, 0], _parts(P, data, calls))
        assert calls == [1]
        assert cache.stats.slice_refreshes == 1
        np.testing.assert_array_equal(P.npy(out3[0]),
                                      [[0] * 4, [7] * 4, [2] * 4])
        np.testing.assert_array_equal(P.npy(out3[1])[0], 0.0)

    def test_stale_epoch_restores_refresh(self, P):
        cache = P.Cache(2)
        data = [(np.zeros(3, np.int32),), (np.zeros(3, np.int32),)]
        cache.get("f", [4, 0], _parts(P, data))
        data[0] = (np.ones(3, np.int32),)
        out = cache.get("f", [5, 0], _parts(P, data))
        np.testing.assert_array_equal(P.npy(out[0])[0], 1)

    def test_shape_change_rebuilds_family(self, P):
        cache = P.Cache(2)
        data = [(np.zeros((2, 2), np.float32),),
                (np.ones((2, 2), np.float32),)]
        cache.get("f", [0, 0], _parts(P, data))
        data = [(np.zeros((4, 2), np.float32),),
                (np.ones((4, 2), np.float32),)]
        calls = []
        out = cache.get("f", [1, 0], _parts(P, data, calls))
        assert cache.stats.rebuilds == 2
        assert sorted(calls) == [0, 1]
        assert tuple(out[0].shape) == (2, 4, 2)
        cache.get("f", [1, 0], _parts(P, data))
        assert cache.stats.hits == 1

    def test_failed_refresh_commits_nothing(self, P):
        cache = P.Cache(2)
        data = [(np.zeros(3, np.int32),), (np.ones(3, np.int32),)]
        cache.get("f", [0, 0], _parts(P, data))
        data[0] = (np.full(3, 5, np.int32),)

        def bad_parts(s):
            if s == 1:
                raise RuntimeError("boom")
            return tuple(P.arr(a) for a in data[s])

        with pytest.raises(RuntimeError):
            cache.get("f", [1, 1], bad_parts)
        assert cache.epochs("f") == [0, 0]
        out = cache.get("f", [1, 1], _parts(P, data))
        np.testing.assert_array_equal(P.npy(out[0]), [[5, 5, 5], [1, 1, 1]])

    def test_donate_flag_safe_on_cpu(self, P):
        cache = P.Cache(2, donate=True)
        data = [(np.zeros(3, np.int32),), (np.ones(3, np.int32),)]
        old = cache.get("f", [0, 0], _parts(P, data))
        data[1] = (np.full(3, 9, np.int32),)
        out = cache.get("f", [0, 3], _parts(P, data))
        np.testing.assert_array_equal(P.npy(out[0]), [[0, 0, 0], [9, 9, 9]])
        np.testing.assert_array_equal(P.npy(old[0]), [[0, 0, 0], [1, 1, 1]])

    def test_epoch_arity_checked_and_invalidate(self, P):
        cache = P.Cache(2)
        with pytest.raises(ValueError):
            cache.get("f", [0], lambda s: (P.arr(np.zeros(1)),))
        data = [(np.zeros(2, np.int32),), (np.zeros(2, np.int32),)]
        cache.get("f", [0, 0], _parts(P, data))
        assert "f" in cache and cache.epochs("f") == [0, 0]
        cache.invalidate("f")
        assert "f" not in cache and cache.epochs("f") is None
        cache.get("f", [0, 0], _parts(P, data))
        assert cache.stats.rebuilds == 2


# ---------------------------------------------------------------------------
# The publish path (the reference's TestPublishPath).
# ---------------------------------------------------------------------------

class TestPublishPath:
    def test_first_publish_creates_family_zeroed(self, P):
        cache = P.Cache(3)
        cache.publish("v", 1, (P.arr(np.full((4,), 7, np.int32)),), epoch=5)
        assert cache.published("v") == [False, True, False]
        assert cache.epochs("v") == [0, 5, 0]
        stack, = cache.handle("v")
        np.testing.assert_array_equal(P.npy(stack),
                                      [[0] * 4, [7] * 4, [0] * 4])
        assert cache.stats.publish_refreshes == 1
        assert cache.stats.rebuilds == 1
        assert cache.resident_bytes()["v"] == P.nbytes(stack)

    def test_get_without_parts_is_epoch_check_plus_handle(self, P):
        cache = P.Cache(2)
        cache.publish("v", 0, (P.arr(np.ones((2,), np.int32)),), epoch=3)
        cache.publish("v", 1, (P.arr(np.full((2,), 2, np.int32)),), epoch=1)
        out = cache.get("v", [3, 1])
        assert out is cache.handle("v")
        assert cache.stats.hits == 1
        assert cache.stats.lookup_refreshes == 0
        assert cache.get("v", [2, 0]) is out

    def test_lagging_push_family_is_writer_order_violation(self, P):
        cache = P.Cache(2)
        with pytest.raises(RuntimeError, match="never published"):
            cache.get("v", [0, 0])
        cache.publish("v", 0, (P.arr(np.zeros((2,), np.int32)),), epoch=1)
        with pytest.raises(RuntimeError, match="lags the reader"):
            cache.get("v", [1, 2])

    def test_touch_advances_epoch_without_data(self, P):
        cache = P.Cache(2)
        cache.touch("v", 0, epoch=9)
        assert "v" not in cache
        cache.publish("v", 0, (P.arr(np.ones((2,), np.int32)),), epoch=1)
        before = cache.handle("v")
        cache.touch("v", 0, epoch=4)
        assert cache.epochs("v") == [4, 0]
        assert cache.handle("v") is before
        cache.touch("v", 0, epoch=2)
        assert cache.epochs("v") == [4, 0]

    def test_seed_publishes_every_shard(self, P):
        cache = P.Cache(2)
        z = P.arr(np.zeros((3, 2), np.float32))
        cache.seed("kv", [(z, z), (z, z)])
        assert cache.published("kv") == [True, True]
        assert cache.epochs("kv") == [0, 0]
        k, v = cache.get("kv", [0, 0])
        assert tuple(k.shape) == (2, 3, 2) and tuple(v.shape) == (2, 3, 2)

    def test_publish_validates_part_count_dtype_rank(self, P):
        cache = P.Cache(2)
        cache.publish("v", 0, (P.arr(np.zeros((2,), np.int32)),), epoch=1)
        with pytest.raises(ValueError, match="parts for"):
            cache.publish("v", 0, (P.arr(np.zeros((2,), np.int32)),) * 2,
                          epoch=2)
        with pytest.raises(ValueError, match="dtypes changed"):
            cache.publish("v", 0, (P.arr(np.zeros((2,), np.float32)),),
                          epoch=2)
        with pytest.raises(ValueError, match="ranks changed"):
            cache.publish("v", 0, (P.arr(np.zeros((2, 2), np.int32)),),
                          epoch=2)
        with pytest.raises(ValueError, match="shard"):
            cache.publish("v", 2, (P.arr(np.zeros((2,), np.int32)),),
                          epoch=2)

    def test_smaller_part_pads_to_extent(self, P):
        cache = P.Cache(2)
        cache.publish("v", 0, (P.arr(np.full((4,), 1, np.int32)),), epoch=1)
        cache.publish("v", 1, (P.arr(np.full((2,), 2, np.int32)),), epoch=1)
        stack, = cache.get("v", [1, 1])
        np.testing.assert_array_equal(P.npy(stack),
                                      [[1, 1, 1, 1], [2, 2, 0, 0]])

    def test_grow_past_extent_restacks_without_blocking_readers(self, P):
        cache = P.Cache(2)
        cache.publish("v", 0, (P.arr(np.full((2, 2), 3, np.int32)),),
                      epoch=1)
        cache.publish("v", 1, (P.arr(np.full((2, 2), 4, np.int32)),),
                      epoch=1)
        old, = cache.get("v", [1, 1])
        old_copy = P.npy(old).copy()
        built = cache.stats.rebuilds
        cache.publish("v", 0, (P.arr(np.full((4, 2), 5, np.int32)),),
                      epoch=2)
        assert cache.stats.rebuilds == built + 1
        np.testing.assert_array_equal(P.npy(old), old_copy)
        new, = cache.get("v", [2, 1])
        assert tuple(new.shape) == (2, 4, 2)
        np.testing.assert_array_equal(P.npy(new[0]), 5)
        np.testing.assert_array_equal(P.npy(new[1][:2]), 4)
        np.testing.assert_array_equal(P.npy(new[1][2:]), 0)
        assert cache.resident_bytes()["v"] == P.nbytes(new)

    def test_slice_of_memoized_per_publish(self, P):
        cache = P.Cache(2)
        assert cache.slice_of("v", 0) is None
        cache.publish("v", 0, (P.arr(np.full((3,), 1, np.int32)),), epoch=1)
        s1 = cache.slice_of("v", 0)
        assert cache.slice_of("v", 0) is s1
        np.testing.assert_array_equal(P.npy(s1[0]), 1)
        cache.publish("v", 1, (P.arr(np.full((3,), 2, np.int32)),), epoch=1)
        s2 = cache.slice_of("v", 0)
        assert s2 is not s1
        np.testing.assert_array_equal(P.npy(s2[0]), 1)
        np.testing.assert_array_equal(P.npy(cache.slice_of("v", 1)[0]), 2)

    def test_publish_if_present_only_warms_existing(self, P):
        cache = P.Cache(2)
        calls = []

        def parts():
            calls.append(1)
            return (P.arr(np.zeros((2,), np.int32)),)

        cache.publish_if_present("t", 0, parts, epoch=1)
        assert calls == [] and "t" not in cache
        cache.get("t", [0, 0],
                  lambda s: (P.arr(np.full((2,), s, np.int32)),))
        cache.publish_if_present("t", 0, parts, epoch=1)
        assert calls == [1] and cache.epochs("t") == [1, 0]

    def test_invalidate_resets_published_flags_and_resident(self, P):
        cache = P.Cache(2)
        cache.publish("v", 0, (P.arr(np.zeros((2,), np.int32)),), epoch=1)
        cache.invalidate("v")
        assert cache.published("v") is None
        assert "v" not in cache.resident_bytes()
        assert cache.slice_of("v", 0) is None

    def test_concurrent_readers_during_publish_churn(self, P):
        """A writer thread publishes growing slices while readers spin on
        slice_of/get: every observed slice is internally consistent and
        never older than the epoch the reader asked for."""
        cache = P.Cache(2)
        for s in range(2):
            cache.publish("v", s, (P.arr(np.zeros((4,), np.int32)),
                                   P.arr(np.zeros((4,), np.int32))), epoch=0)
        published = [0, 0]
        errors = []
        stop = threading.Event()

        def reader():
            try:
                while not stop.is_set():
                    eps = list(published)
                    k, v = cache.get("v", eps)
                    for s in range(2):
                        a, b = P.npy(k[s]), P.npy(v[s])
                        assert np.array_equal(b, -a), "torn slice"
                        assert a[0] >= eps[s], "stale slice past its epoch"
                    sl = cache.slice_of("v", 0)
                    assert np.array_equal(P.npy(sl[1]), -P.npy(sl[0]))
            except Exception as e:                # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=reader) for _ in range(2)]
        for t in threads:
            t.start()
        try:
            for e in range(1, 40):
                s = e % 2
                n = 4 + (e // 8) * 2
                a = np.arange(e, e + n, dtype=np.int32)
                cache.publish("v", s, (P.arr(a), P.arr(-a)), epoch=e)
                published[s] = e
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60.0)
        assert not errors, errors
        assert cache.stats.lookup_refreshes == 0


# ---------------------------------------------------------------------------
# Port only: the copy-on-write publish.
# ---------------------------------------------------------------------------

def test_publish_is_copy_on_write():
    """With ``donate=False`` a handle or a slice taken before a publish, a
    pull refresh or a re-stack is unchanged after it, and every new stack
    is a new tensor."""
    cache = TCache(2)
    k0 = torch.arange(6, dtype=torch.int32).reshape(3, 2)
    cache.publish("v", 0, (k0, -k0), epoch=1)
    cache.publish("v", 1, (k0 + 10, -k0 - 10), epoch=1)
    handle = cache.handle("v")
    sl = cache.slice_of("v", 1)
    before = [t.clone() for t in handle + sl]
    cache.publish("v", 1, (k0 + 20, -k0 - 20), epoch=2)
    new = cache.handle("v")
    assert all(a is not b for a, b in zip(new, handle))
    assert all(torch.equal(a, b) for a, b in zip(handle + sl, before))
    assert torch.equal(cache.slice_of("v", 1)[0], k0 + 20)
    assert torch.equal(cache.slice_of("v", 0)[1], -k0)
    # a re-stack leaves the old stack as it was, too
    cache.publish("v", 0, (torch.ones(5, 2, dtype=torch.int32),) * 2,
                  epoch=3)
    assert all(torch.equal(a, b) for a, b in zip(handle + sl, before))
    # a pull refresh writes a clone as well
    t0 = torch.zeros(4, dtype=torch.int32)
    pull = cache.get("t", [0, 0], lambda s: (t0 + s,))
    pull_before = pull[0].clone()
    sl_t = cache.slice_of("t", 1)
    got = cache.get("t", [0, 4], lambda s: (t0 + 7,))
    assert got[0] is not pull[0]
    assert torch.equal(pull[0], pull_before) and torch.equal(sl_t[0], t0 + 1)
    assert torch.equal(got[0][1], t0 + 7)


def test_uint32_parts_and_device():
    """uint32 parts (the views' dtype) stack, pad and slice bit for bit; the
    stack lies on the parts' device."""
    cache = TCache(2)
    part = torch.from_numpy(np.asarray(
        [0xFFFFFFFF, 7, 0x80000000], np.uint32).view(np.int32)).view(
            torch.uint32)
    cache.publish("v", 1, (part[:2],), epoch=1)
    cache.publish("v", 0, (part,), epoch=1)
    stack, = cache.handle("v")
    assert stack.dtype == torch.uint32 and stack.device == part.device
    np.testing.assert_array_equal(
        stack.view(torch.int32).numpy().view(np.uint32),
        [[0xFFFFFFFF, 7, 0x80000000], [0xFFFFFFFF, 7, 0]])
    assert cache.slice_of("v", 1)[0].dtype == torch.uint32
