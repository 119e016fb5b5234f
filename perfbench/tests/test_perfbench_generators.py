"""The benchmark's generators and reference on the CPU: keys against
``chip_smoke.make_keys``, YCSB's zipfian against its closed form, and the
plain reference against ``repro_torch`` (``device="cpu"``) on both routes
of both configurations."""
import math

import numpy as np
import pytest
import torch

from perfbench import keys as keygen
from perfbench import zipf
from perfbench.references.kv_map import KVMap
from repro_torch.core import extendible_hashing as eh
from repro_torch.core.sharded_eh import ShardedShortcutEH
from repro_torch.core.shortcut_eh import ShortcutEH

SEEDS = [0, 7, 2**31 + 11, 2**33 + 5]
M32 = 0xFFFFFFFF


def fnvhash64_java(val: int) -> int:
    """YCSB's ``Utils.fnvhash64`` on Python ints, with Java's ``long``
    arithmetic and ``Math.abs``."""
    h = 0xCBF29CE484222325
    for _ in range(8):
        h ^= val & 0xFF
        val >>= 8
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    if h >= 1 << 63:
        h -= 1 << 64
    return abs(h)


def rank_cdf(p: zipf.ZipfParams, k: int) -> float:
    """P(rank < k) of ``ZipfianGenerator.nextLong``'s closed form, k >= 2:
    rank = floor(items * (eta u - eta + 1)^alpha) < k, solved for u (below
    (1 + 0.5^theta) / zetan, u gives rank 0 or 1)."""
    u = 1.0 + ((k / p.items) ** (1.0 / p.alpha) - 1.0) / p.eta
    return min(1.0, max(u, (1.0 + p.half_pow) / p.zetan))


def zeta(n: int, theta: float) -> float:
    return math.fsum(i ** -theta for i in range(1, n + 1))


def _inverse_fmix32(y: int) -> int:
    y ^= y >> 16
    y = (y * pow(0xC2B2AE35, -1, 1 << 32)) & M32
    y ^= (y >> 13) ^ (y >> 26)
    y = (y * pow(0x85EBCA6B, -1, 1 << 32)) & M32
    return y ^ (y >> 16)


def _np_fmix32(x):
    """``chip_smoke.fmix32`` as written there (numpy, uint32)."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_are_chip_smokes(seed):
    import chip_smoke
    n = 5000
    want, _, absent = chip_smoke.make_keys(n, 100, seed)
    got = keygen.make_keys(n + 100, seed, "cpu").numpy().view(np.uint32)
    assert np.array_equal(got[:n], want)
    assert np.array_equal(got[n:], absent)


def test_keys_skip_the_empty_pattern_and_stay_distinct():
    """A seed whose counter passes the one value that fmix32 maps to the
    EMPTY pattern: that key is left out, as chip_smoke leaves it out."""
    import chip_smoke
    x0 = _inverse_fmix32(M32)
    assert int(keygen.fmix32(torch.tensor([x0]))[0]) == M32
    base = (x0 - 5) & M32
    seed = ((base - 0x7F4A7C15) * pow(0x9E3779B9, -1, 1 << 32)) & M32
    assert keygen.counter_base(seed) == base
    got = keygen.make_keys(20, seed, "cpu")
    want, _, _ = chip_smoke.make_keys(20, 0, seed)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert (got != -1).all()
    x = np.arange(0, 1 << 22, dtype=np.uint32) + np.uint32(base)
    assert np.array_equal(_np_fmix32(x), keygen.fmix32(
        torch.from_numpy(x.astype(np.int64))).numpy().astype(np.uint32))
    k = keygen.make_keys(1 << 16, seed, "cpu")
    assert torch.unique(k).numel() == k.numel()


def test_values_below_miss_and_seeded():
    a = keygen.make_values(1000, 5, "cpu")
    assert torch.equal(a, keygen.make_values(1000, 5, "cpu"))
    assert not torch.equal(a, keygen.make_values(1000, 6, "cpu"))
    assert (a != -1).all()


def test_fnvhash64_is_ycsbs():
    vals = [0, 1, 2, 255, 256, 65535, 2**31 - 1, 2**32 + 17, 10**10,
            123456789012]
    rng = np.random.default_rng(1)
    vals += rng.integers(0, 10**10, 2000).tolist()
    items = 100_000_000
    got = zipf.fnvhash64_mod(torch.tensor(vals, dtype=torch.int64), items)
    assert got.tolist() == [fnvhash64_java(v) % items for v in vals]


def test_zipf_ranks_follow_the_closed_form():
    p = zipf.ZipfParams()
    g = torch.Generator().manual_seed(11)
    n = 2_000_000
    r = zipf.zipf_ranks(n, p, g, "cpu")
    # ranks 0 and 1 exactly, then decades of ranks from the closed form
    want = {0: 1 / p.zetan, 1: p.half_pow / p.zetan}
    edges = [2, 10, 100, 1000, 10**4, 10**6]
    for lo, hi in zip(edges, edges[1:]):
        want[(lo, hi)] = rank_cdf(p, hi) - rank_cdf(p, lo)
    for k, pr in want.items():
        got = (((r >= k[0]) & (r < k[1])).sum() if isinstance(k, tuple)
               else (r == k).sum()).item() / n
        sd = (pr * (1 - pr) / n) ** 0.5
        assert abs(got - pr) < 5 * sd, (k, got, pr)
    # and the closed form is Zipf's law with constant 0.99 at those ranks
    assert abs(want[0] - 1 / zipf.ZETAN) < 1e-12
    assert abs(want[1] / want[0] - 2 ** -0.99) < 1e-12
    zipf_mass = sum(i ** -0.99 for i in range(11, 101)) / p.zetan
    assert abs(want[(10, 100)] / zipf_mass - 1) < 0.05


def test_zipf_small_item_count_matches_zeta():
    # with zetan = zeta(n, theta) computed, the closed form's rank 0 and 1
    # carry Zipf's probabilities over n items exactly
    n, theta = 1000, 0.99
    zn = zeta(n, theta)
    p = zipf.ZipfParams(items=n, theta=theta, zetan=zn)
    g = torch.Generator().manual_seed(3)
    r = zipf.zipf_ranks(1_000_000, p, g, "cpu")
    assert int(r.max()) < n
    for k in (0, 1):
        pr = (k + 1) ** -theta / zn
        got = (r == k).double().mean().item()
        assert abs(got - pr) < 5 * (pr * (1 - pr) / r.numel()) ** 0.5


def test_scrambled_items_in_range_and_skewed():
    g = torch.Generator().manual_seed(2)
    items = 100_000_000
    x = zipf.scrambled_zipfian(200_000, items, g, "cpu")
    assert int(x.min()) >= 0 and int(x.max()) < items
    vals, counts = torch.unique(x, return_counts=True)
    # the hottest item is rank 0's scramble, about 1/ZETAN of the draws
    assert vals[counts.argmax()].item() == fnvhash64_java(0) % items
    assert abs(counts.max().item() / x.numel() - 1 / zipf.ZETAN) < 0.003


def _flat(async_mapper=False):
    return ShortcutEH(10, 16, 512, async_mapper=async_mapper, device="cpu")


def _sharded():
    return ShardedShortcutEH(10, 16, 256, num_shards=4, device="cpu")


def _load(ix, keys, vals, batches=4):
    step = -(-keys.numel() // batches)
    for i in range(0, keys.numel(), step):
        ix.insert(keys[i:i + step], vals[i:i + step])


@pytest.mark.parametrize("seed", [1, 2**32 + 9])
@pytest.mark.parametrize("config", ["flat", "sharded"])
def test_reference_agrees_with_the_port(seed, config):
    n = 2000
    both = keygen.make_keys(n + 500, seed, "cpu")
    keys, absent = both[:n], both[n:]
    vals = keygen.make_values(n, seed, "cpu")
    # overwrite some keys with new values: the reference keeps the last
    keys2 = keys[:300]
    vals2 = keygen.make_values(300, seed + 1, "cpu")
    ix = _flat() if config == "flat" else _sharded()
    _load(ix, keys, vals)
    ix.insert(keys2, vals2)
    ref = KVMap(torch.cat([keys, keys2]), torch.cat([vals, vals2]))
    probes = torch.cat([keys, absent])[torch.randperm(n + 500)]
    want = ref.lookup(probes)
    assert (want == -1).sum() == 500

    def look():
        out = ix.lookup(probes) if config == "flat" else \
            ix.lookup_batched(probes)
        return out.view(torch.int32)

    assert not ix.in_sync()
    trad = look()                       # the gate refuses: traditional
    ix.pump()
    assert ix.in_sync()
    sc = look()                         # in sync: the shortcut
    assert ix.routed_traditional >= 1 and ix.routed_shortcut >= 1
    assert torch.equal(trad, want) and torch.equal(sc, want)
    if config == "flat":
        assert torch.equal(eh.eh_lookup_many(ix.state, probes).view(
            torch.int32), want)
    ix.close()


def test_reference_block_edges():
    keys = keygen.make_keys(10, 4, "cpu")
    vals = keygen.make_values(10, 4, "cpu")
    ref = KVMap(keys, vals)
    assert torch.equal(ref.lookup(keys), vals)
    empty = KVMap(keys[:0], vals[:0])
    assert (empty.lookup(keys) == -1).all()
