"""Stacked shards for the sharded lookups' flat-key mode, shared by
``test_torch_eh_lookup.py`` (the plain versions) and
``test_torch_eh_lookup_mock.py`` (the CUDA source on the CPU stand-in).
It imports no JAX, so the stand-in's subprocesses start quickly."""
import numpy as np
import pytest
import torch

from repro_torch.convert import stack_shards, state_to_numpy, view_to_numpy
from repro_torch.core import extendible_hashing as teh
from repro_torch.core.hashing import shard_of_keys
from repro_torch.kernels import eh_lookup as tk


def distinct_keys(rng, n, lo=1, hi=2**31):
    """``n`` distinct uint32 keys in ``[lo, hi)``, drawn without building the
    whole range."""
    return (rng.choice(hi - lo, n, replace=False) + lo).astype(np.uint32)


FLAT_TILE = 64


@pytest.fixture(scope="module", params=[2, 4, 8], ids=lambda n: f"N{n}")
def flat_stacks(request):
    """N shards, each built by the port's insert from the keys that route
    to it (so shard s holds exactly its own keys), stacked as the operand
    cache stacks them; shard 0's table is left empty.  Also each shard's
    present keys and absent keys routed to each shard."""
    N = request.param
    bits = N.bit_length() - 1
    rng = np.random.default_rng(100 + N)
    keys = distinct_keys(rng, 160 * N)
    vals = rng.integers(0, 2**32 - 1, keys.size, dtype=np.uint32)
    sid = shard_of_keys(torch.from_numpy(keys.view(np.int32)), bits).numpy()
    absent = distinct_keys(rng, 64 * N, lo=2**31, hi=2**32 - 2)
    asid = shard_of_keys(torch.from_numpy(absent.view(np.int32)),
                         bits).numpy()
    states, views, present, missing = [], [], [], []
    for s in range(N):
        mine = (sid == s) & (s != 0)
        # the top `bits` of a shard's hashes agree: depth past them
        st = teh.eh_insert_many(
            teh.eh_create(8 + bits, 8, 256, device="cpu"), keys[mine],
            vals[mine])
        assert int(st.dropped) == 0
        vs = max(1, 1 << int(st.global_depth))
        vk, vv = teh.compose_shortcut(st, vs)
        states.append(state_to_numpy(st))
        views.append(view_to_numpy((vk, vv, vs.bit_length() - 1)))
        present.append(keys[sid == s])
        missing.append(absent[asid == s])
    trad, view = stack_shards(states, views, device="cpu")
    assert len({v[0].shape[0] for v in views}) > 1 or N == 2
    return dict(N=N, bits=bits, trad=trad, view=view, present=present,
                missing=missing)


def flat_case(fs, case, rng):
    """The probe batch of ``case`` (input order shuffled)."""
    N, present, missing = fs["N"], fs["present"], fs["missing"]
    if case == "every_shard":
        k = np.concatenate(present + missing)
    elif case == "shard_without_keys":
        k = np.concatenate([p for s, p in enumerate(present + missing)
                            if s % N != 1])
    elif case == "one_shard":
        k = np.concatenate([present[N - 1], missing[N - 1]])
    elif case == "one_key":
        k = present[N - 1][:1]
    elif case == "off_tile":
        k = np.concatenate(present + missing)[:2 * FLAT_TILE + 5]
    else:                                   # "absent"
        k = np.concatenate(missing)
    return rng.permutation(k)


ARMS = ("shortcut", "traditional", "routed")


def flat_arm(fs, arm, keys, **kw):
    """One of the three sharded lookups on ``keys`` (padded or flat)."""
    if arm == "shortcut":
        return tk.sharded_shortcut_lookup(keys, *fs["view"], tile=FLAT_TILE,
                                          **kw)
    if arm == "traditional":
        return tk.sharded_eh_lookup(keys, *fs["trad"], tile=FLAT_TILE, **kw)
    flags = torch.zeros(fs["N"], dtype=torch.int32)
    flags[1] = 1                            # one shard traditional
    return tk.sharded_routed_lookup(keys, *fs["trad"], *fs["view"], flags,
                                    tile=FLAT_TILE, **kw)
