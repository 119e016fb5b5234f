"""Port parity: ``repro_torch.kernels.ragged_copy`` (its plain version, on
CPU tensors) against the Pallas kernel of ``repro.kernels.ragged_copy`` in
interpret mode, whose sequential grid lets the last duplicate slot win."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ragged_copy import ragged_copy as jrc
from repro_torch.core import hashing
from repro_torch.kernels import ops
from repro_torch.kernels.ragged_copy import ragged_copy as trc

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "uint32": (jnp.uint32, torch.uint32)}


def to_torch(x: np.ndarray, dtype) -> torch.Tensor:
    if dtype == torch.uint32:
        return torch.from_numpy(x.astype(np.uint32).view(np.int32)).view(
            torch.uint32)
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.numpy() if t.dtype == torch.uint32 else t.float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("row", [(8,), (4, 6)])
@pytest.mark.parametrize("duplicates", [False, True])
def test_matches_pallas(rng, dtype, row, duplicates):
    jd, td = DTYPES[dtype]
    scale = 1000 if dtype == "uint32" else 1
    view = (rng.normal(size=(20,) + row) * scale).astype(np.float32)
    pool = (rng.normal(size=(40,) + row) * scale).astype(np.float32)
    if dtype == "uint32":
        view, pool = np.abs(view), np.abs(pool)
    if duplicates:
        slots = rng.integers(0, 20, 30).astype(np.int32)
    else:
        slots = rng.choice(20, 7, replace=False).astype(np.int32)
    offs = rng.integers(0, 40, slots.size).astype(np.int32)
    want = np.asarray(jrc(jnp.asarray(view).astype(jd),
                          jnp.asarray(pool).astype(jd), jnp.asarray(slots),
                          jnp.asarray(offs))).astype(
        np.uint32 if dtype == "uint32" else np.float32)
    tv = to_torch(view, td)
    out = trc(tv, to_torch(pool, td), slots, offs)
    assert out is tv                      # in place
    np.testing.assert_array_equal(to_numpy(out), want)
    out = ops.remap_rows(to_torch(view, td), to_torch(pool, td),
                         torch.from_numpy(slots), torch.from_numpy(offs))
    np.testing.assert_array_equal(to_numpy(out), want)


def test_last_duplicate_wins_and_rest_untouched():
    view = torch.zeros((6, 4), dtype=torch.int32)
    pool = torch.arange(40, dtype=torch.int32).reshape(10, 4)
    trc(view, pool, [2, 2, 5, 2], [1, 7, 3, 9])
    assert torch.equal(view[2], pool[9]) and torch.equal(view[5], pool[3])
    assert int(view[[0, 1, 3, 4]].abs().sum()) == 0


def test_rejects_mismatched_rows():
    with pytest.raises(ValueError):
        trc(torch.zeros((4, 3)), torch.zeros((4, 2)), [0], [0])
    with pytest.raises(ValueError):
        trc(torch.zeros((4, 3)), torch.zeros((4, 3), dtype=torch.bfloat16),
            [0], [0])
    with pytest.raises(ValueError):
        trc(torch.zeros((4, 3)), torch.zeros((4, 3)), [0, 1], [0])
    empty = hashing.full((3, 2), 7, torch.uint32, "cpu")
    assert trc(empty, empty.clone(), [], []) is empty
