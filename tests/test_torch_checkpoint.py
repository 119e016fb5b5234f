"""The port's checkpointer (``repro_torch.checkpoint.checkpointer``): the
twins of tests/test_checkpoint.py (atomicity, the async writer, retention,
the manifest) with a bfloat16 round trip bit for bit in place of the mesh
re-sharding test (one card has no mesh), restores onto the device and
dtype of ``like``, and the reference's manifest read back from a
checkpoint the JAX package wrote."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step
from repro_torch.optim.adamw import AdamWState


def make_tree(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 4), generator=g).to(dtype),
                   "b": torch.zeros((4,), dtype=dtype)},
        "opt": AdamWState(step=torch.tensor(7, dtype=torch.int32),
                          m={"w": torch.ones((8, 4)), "b": torch.zeros((4,))},
                          v={"w": {"vr": torch.ones((8,)),
                                   "vc": torch.ones((4,))},
                             "b": torch.zeros((4,))}),
    }


def leaves(tree):
    from repro_torch.checkpoint.checkpointer import _flatten
    return list(_flatten(tree).values())


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = make_tree()
    ck.save(3, tree)
    assert latest_step(str(tmp_path)) == 3
    out = ck.restore(3, make_tree(seed=1))
    for a, b in zip(leaves(tree), leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(out["opt"], AdamWState)  # NamedTuple reconstructed
    assert out["params"]["w"] is not tree["params"]["w"]


def test_bfloat16_roundtrip_bitwise(tmp_path):
    """numpy has no bfloat16: the tensor is stored as its uint16 bits with
    the manifest dtype "bfloat16" and comes back bit for bit, NaN payloads
    and signed zeros included."""
    ck = Checkpointer(str(tmp_path))
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    tree = {"x": bits.view(torch.bfloat16).reshape(256, 256),
            "y": make_tree(dtype=torch.bfloat16)["params"]["w"]}
    ck.save(1, tree)
    with open(tmp_path / "step_1" / "MANIFEST.json") as f:
        manifest = json.load(f)
    assert {m["dtype"] for m in manifest["arrays"].values()} == {"bfloat16"}
    raw = np.load(tmp_path / "step_1" / manifest["arrays"]["x"]["file"])
    assert raw.dtype == np.uint16
    out = ck.restore(1, {"x": torch.zeros((256, 256), dtype=torch.bfloat16),
                         "y": torch.zeros((8, 4), dtype=torch.bfloat16)})
    for k in tree:
        assert out[k].dtype == torch.bfloat16
        assert torch.equal(out[k].view(torch.int16),
                           tree[k].view(torch.int16))


def test_restore_takes_the_dtype_of_like(tmp_path):
    ck = Checkpointer(str(tmp_path))
    w = torch.randn(4, 4)
    ck.save(1, {"w": w})
    out = ck.restore(1, {"w": torch.zeros((4, 4), dtype=torch.float64)})
    assert out["w"].dtype == torch.float64
    assert torch.equal(out["w"], w.double())


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = make_tree()
    ck.save_async(5, tree)
    ck.wait()
    assert latest_step(str(tmp_path)) == 5
    out = ck.restore(5, tree)
    assert torch.equal(out["params"]["w"], tree["params"]["w"])


def test_async_save_error_surfaces_in_wait(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))

    def broken(step, host):
        raise OSError("disk full")
    monkeypatch.setattr(ck, "_write", broken)
    ck.save_async(1, make_tree())
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()  # reported once


def test_crashed_tmp_dir_ignored_and_gcd(tmp_path):
    ck = Checkpointer(str(tmp_path))
    crash = tmp_path / "step_9.tmp"
    crash.mkdir()
    (crash / "arr_00000.npy").write_bytes(b"garbage")
    assert latest_step(str(tmp_path)) is None
    ck.save(10, make_tree())
    assert latest_step(str(tmp_path)) == 10
    assert not crash.exists()          # GC'd by the successful save


def test_retention_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        ck.save(s, make_tree(s))
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [3, 4]


def test_restore_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.zeros((4, 4))})
    with pytest.raises(ValueError, match="shape"):
        ck.restore(1, {"w": torch.zeros((8, 4))})


def test_restore_missing_array_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.zeros((4,))})
    with pytest.raises(KeyError):
        ck.restore(1, {"w": torch.zeros((4,)), "extra": torch.zeros((2,))})


def test_manifest_is_complete(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, make_tree())
    with open(tmp_path / "step_1" / "MANIFEST.json") as f:
        manifest = json.load(f)
    assert manifest["step"] == 1
    files = set(os.listdir(tmp_path / "step_1")) - {"MANIFEST.json"}
    assert files == {m["file"] for m in manifest["arrays"].values()}
    assert manifest["arrays"]["opt/v/w/vr"]["shape"] == [8]
    assert manifest["arrays"]["opt/step"]["dtype"] == "int32"


def test_reads_a_checkpoint_of_the_jax_package(tmp_path):
    """The same manifest and files: a checkpoint the reference's
    Checkpointer wrote (a JAX AdamWState, factored entries included)
    restores into the port's tensors."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    from repro.optim.adamw import adamw_init as j_adamw_init
    params = {"w": jax.random.normal(jax.random.PRNGKey(0), (128, 256)),
              "b": jnp.arange(5.0)}
    opt = j_adamw_init(params, factored=True)
    JCheckpointer(str(tmp_path)).save(4, {"params": params, "opt": opt})
    like = {"params": {"w": torch.zeros((128, 256)), "b": torch.zeros(5)},
            "opt": convert.opt_state_from_numpy(
                jax.tree.map(np.asarray, opt), device="cpu")}
    out = Checkpointer(str(tmp_path)).restore(4, like)
    np.testing.assert_array_equal(out["params"]["w"].numpy(),
                                  np.asarray(params["w"]))
    assert out["opt"].v["w"]["vc"].shape == (256,)
    assert int(out["opt"].step) == 0
