"""Port parity for ``repro_torch.kvcache.prefix_index`` against
``repro.kvcache.prefix_index``: the traces of ``tests/test_prefix_index.py``
through both packages give the same ``match_prefix`` results, the same
chain keys and the same ``stats()`` after every step."""
import warnings

import numpy as np
import pytest

from repro.kvcache.prefix_index import PrefixCacheIndex as JIndex
from repro_torch.kvcache.prefix_index import PrefixCacheIndex as TIndex


class Pair:
    """One index per package, driven by the same calls."""

    def __init__(self, **kw):
        self.j = JIndex(**kw)
        self.t = TIndex(device="cpu", **kw)

    def match(self, toks):
        got = self.t.match_prefix(toks)
        assert got == self.j.match_prefix(toks)
        self.check()
        return got

    def insert(self, toks, blocks):
        n = self.t.insert_prefix(toks, blocks)
        assert n == self.j.insert_prefix(toks, blocks)
        self.check()
        return n

    def pump(self):
        self.j.pump()
        self.t.pump()
        self.check()

    def check(self):
        assert self.t.stats() == self.j.stats()
        jv, tv = self.j._view, self.t._view
        assert (jv is None) == (tv is None)
        if jv is not None:
            for a, b in zip(jv[:3], tv[:3]):
                np.testing.assert_array_equal(a, b)
            assert jv[3] == tv[3]

    def close(self):
        self.j.close()
        self.t.close()


def toks(rng, n, lo=0, hi=50000):
    return rng.integers(lo, hi, n).tolist()


def test_roundtrip_partial_and_diverging(rng):
    p = Pair(block_size=4)
    shared = toks(rng, 16)
    full = shared + toks(rng, 16)
    assert p.match(full) == (0, [])
    p.insert(full, list(range(100, 108)))
    p.pump()
    assert p.match(full) == (32, list(range(100, 108)))
    assert p.match(shared + toks(rng, 16, 50001, 60000)) == (16, [100, 101,
                                                                  102, 103])
    assert p.match(toks(rng, 16, 50001, 60000)) == (0, [])
    # identical content at block 1 under another block 0: no match
    assert p.match(toks(rng, 4, 50001, 60000) + full[4:8])[0] == 0
    p.close()


def test_incomplete_blocks_and_chain_keys(rng):
    p = Pair(block_size=8)
    t = toks(rng, 20)
    assert p.insert(t, [1, 2, 3]) == 2
    p.pump()
    assert p.match(t) == (16, [1, 2])
    long = rng.integers(0, 2**31, 64).tolist()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        keys = p.t.chain_keys(long)
    np.testing.assert_array_equal(keys, p.j.chain_keys(long))
    p.close()


def test_shared_system_prompt(rng):
    p = Pair(block_size=4, capacity=8192)
    system = toks(rng, 24)
    p.insert(system, list(range(6)))
    nxt = 6
    for _ in range(20):
        full = system + toks(rng, 8)
        n, blocks = p.match(full)
        assert n >= 24
        p.insert(full, blocks + [nxt, nxt + 1])
        nxt += 2
        p.pump()
    assert p.t.stats()["hits"] == 20
    p.close()


@pytest.mark.parametrize("table_log2,n_chains", [(3, 12), (2, 20)])
def test_prefix_shortcut_growth(rng, table_log2, n_chains):
    p = Pair(block_size=4, table_log2=table_log2, chain_threshold=1.0)
    if n_chains == 20:                       # one bulk insert, many doublings
        t = toks(rng, 80)
        p.insert(t, list(range(20)))
        assert not p.t.prefix_mapper.in_sync(["__global__"])
        p.pump()
        assert p.match(t) == (80, list(range(20)))
    else:
        for i in range(n_chains):
            t = toks(rng, 8)
            p.insert(t, [2 * i, 2 * i + 1])
            if i % 3 == 0:
                p.match(t)                   # stale: the walk answers
            p.pump()
            assert p.match(t) == (8, [2 * i, 2 * i + 1])
    assert p.t.stats()["prefix_routed_shortcut"] >= 1
    assert p.t.prefix_mapper.stats.creates == p.j.prefix_mapper.stats.creates
    p.close()


def test_default_device_is_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TIndex(block_size=4)
