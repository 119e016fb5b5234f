"""Port parity: ``repro_torch.core.rewiring`` against ``repro.core.rewiring``
(pool ring, compose, remap_slots with last-wins duplicates, remap_range)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rewiring as jrw
from repro.kernels.ragged_copy import ragged_copy as jrc
from repro_torch.core import rewiring as trw


def pool_fields(pool):
    return [np.asarray(x) for x in pool]


def test_pool_ring_trace(rng):
    """The same alloc/free trace gives the same offsets and pool fields,
    through exhaustion and recycling."""
    jp = jrw.pool_create(capacity=8, page_slots=4)
    tp = trw.pool_create(capacity=8, page_slots=4, device="cpu")
    live = []
    for step, op in enumerate(rng.random(60) < 0.6):
        if op or not live:
            jp, joff = jrw.pool_alloc(jp)
            tp, toff = trw.pool_alloc(tp)
            assert int(toff) == int(joff)
            if int(joff) >= 0:
                live.append(int(joff))
        else:
            off = live.pop(int(rng.integers(len(live))))
            fill = 9 if step % 3 == 0 else None
            jp = jrw.pool_free(jp, jnp.int32(off), reset_fill=fill)
            tp = trw.pool_free(tp, off, reset_fill=fill)
        for a, b in zip(pool_fields(jp), pool_fields(tp)):
            np.testing.assert_array_equal(b, a)
        assert int(trw.pool_used_pages(tp)) == int(jrw.pool_used_pages(jp))


def test_pool_structured_pages_and_io():
    jp = jrw.pool_create(4, (2, 3), dtype=jnp.float32, fill=1.5)
    tp = trw.pool_create(4, (2, 3), dtype=torch.float32, fill=1.5,
                         device="cpu")
    page = np.arange(6, dtype=np.float32).reshape(2, 3)
    jp = jrw.pool_write(jp, jnp.int32(2), jnp.asarray(page))
    tp2 = trw.pool_write(tp, 2, torch.from_numpy(page))
    np.testing.assert_array_equal(tp2.pages.numpy(), np.asarray(jp.pages))
    assert float(tp.pages[2, 0, 0]) == 1.5          # functional write
    np.testing.assert_array_equal(trw.pool_read(tp2, 2).numpy(), page)
    assert tp2.page_shape == jp.page_shape and tp2.capacity == jp.capacity


def test_uint32_pool_fill():
    tp = trw.pool_create(3, 4, dtype=torch.uint32, fill=0xFFFFFFFF,
                         device="cpu")
    assert (tp.pages.numpy() == np.uint32(0xFFFFFFFF)).all()


def test_compose(rng):
    pages = rng.normal(size=(10, 4)).astype(np.float32)
    directory = np.array([3, 3, 1, 0, 7], np.int32)
    want = np.asarray(jrw.compose(jnp.asarray(pages), jnp.asarray(directory)))
    got = trw.compose(torch.from_numpy(pages), torch.from_numpy(directory))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("duplicates", [False, True])
def test_remap_slots(rng, duplicates):
    pages = rng.normal(size=(10, 4)).astype(np.float32)
    view = rng.normal(size=(6, 4)).astype(np.float32)
    if duplicates:
        slots = np.array([2, 2, 5, 2, 0], np.int32)
        # XLA leaves the winner among duplicates open; the reference's
        # sequential replay is the Pallas kernel
        want = np.asarray(jrc(jnp.asarray(view), jnp.asarray(pages),
                              jnp.asarray(slots),
                              jnp.asarray([1, 7, 3, 9, 4], jnp.int32)))
    else:
        slots = np.array([2, 5, 0], np.int32)
        want = np.asarray(jrw.remap_slots(
            jnp.asarray(view), jnp.asarray(pages), jnp.asarray(slots),
            jnp.asarray([1, 7, 3], jnp.int32)))
    offs = np.array([1, 7, 3, 9, 4][:slots.size], np.int32)
    tv = torch.from_numpy(view.copy())
    got = trw.remap_slots(tv, torch.from_numpy(pages), slots, offs)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tv.numpy(), view)   # functional


@pytest.mark.parametrize("start,length", [(2, 4), (6, 4), (-3, 2), (-9, 2)])
def test_remap_range(rng, start, length):
    pages = rng.normal(size=(10, 4)).astype(np.float32)
    view = np.zeros((8, 4), np.float32)
    want = np.asarray(jrw.remap_range(jnp.asarray(view), jnp.asarray(pages),
                                      jnp.int32(start), length, jnp.int32(6)))
    got = trw.remap_range(torch.from_numpy(view), torch.from_numpy(pages),
                          start, length, 6)
    np.testing.assert_array_equal(got.numpy(), want)
