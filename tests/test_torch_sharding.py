"""Port parity for the logical-axis sharding rules:
``repro_torch.distributed.sharding`` against ``repro.distributed.sharding``
on abstract meshes (an axis-name -> size mapping; the reference's tests use
a ``FakeMesh`` with the same sizes).  Specs are compared exactly: the
port's tuple of entries against the reference ``PartitionSpec``'s.

The twins of ``tests/test_distributed.py``'s ``TestLogicalSpec``,
``TestEHSpecs``, ``TestKVViewSpecs`` and ``TestParamNames`` run first; then
every parameter leaf of every assigned architecture at full size (shape-only
structs in both packages), the decode state and the batch, on the
production meshes 16x16 and 2x16x16."""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ASSIGNED
from repro.configs import get as jget
from repro.data.pipeline import make_batch_specs as j_batch_specs
from repro.distributed import sharding as jshd
from repro.runtime.serve import decode_state_names as j_state_names
from repro.runtime.serve import decode_state_struct as j_state_struct
from repro.runtime.train import param_struct as j_param_struct
from repro_torch.configs import get
from repro_torch.distributed import sharding as shd
from repro_torch.launch.shapes import SHAPES, input_specs
from repro_torch.runtime import serve
from repro_torch.runtime.train import param_struct

MESH = {"data": 16, "model": 16}
MESH3 = {"pod": 2, "data": 16, "model": 16}


class FakeMesh:
    """The reference tests' stand-in for a device mesh."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def spec(*entries):
    return tuple(P(*entries))


class TestLogicalSpec:
    def test_divisible_dims_shard(self):
        assert shd.logical_spec((256, 4096), ("batch", None), MESH) \
            == spec("data")

    def test_indivisible_dim_replicates(self):
        assert shd.logical_spec((8,), ("kv_heads",), MESH) == spec()

    def test_fallback_candidate_used(self):
        assert shd.logical_spec((60,), ("expert",), MESH) == spec()
        assert shd.logical_spec((32,), ("expert",), MESH) == spec("model")

    def test_axis_consumed_once(self):
        assert shd.logical_spec((32000, 64), ("vocab", "heads"), MESH) \
            == spec("model")

    def test_ctx_yields_to_kv_heads(self):
        got = shd.logical_spec((4, 128, 32768, 16, 128),
                               ("layer", "batch", "ctx", "kv_heads",
                                "head_dim"), MESH)
        assert got == spec(None, "data", None, "model")

    def test_ctx_takes_model_when_kv_cannot(self):
        got = shd.logical_spec((4, 128, 32768, 8, 128),
                               ("layer", "batch", "ctx", "kv_heads",
                                "head_dim"), MESH)
        assert got == spec(None, "data", "model")

    def test_multi_pod_batch_tuple(self):
        assert shd.logical_spec((256, 4096), ("batch", None), MESH3) \
            == spec(("pod", "data"))
        assert shd.logical_spec((1,), ("batch",), MESH3) == spec()

    def test_length_mismatch_raises(self):
        with pytest.raises(ValueError):
            shd.logical_spec((4, 4), ("batch",), MESH)


class TestEHSpecs:
    def test_stacked_lookup_operands(self):
        assert shd.logical_spec((16, 1 << 14), ("eh_shard", "eh_dir"),
                                MESH) == spec("data", "model")
        assert shd.logical_spec((16, 4096, 64),
                                ("eh_shard", "eh_buckets", "eh_slots"),
                                MESH) == spec("data", "model")

    def test_indivisible_shards_replicate(self):
        assert shd.logical_spec((2, 1 << 14), ("eh_shard", "eh_dir"),
                                MESH) == spec(None, "model")

    def test_sharded_eh_specs_helper(self):
        class Shaped:
            def __init__(self, shape):
                self.shape = shape
        ops = {"keys": Shaped((16, 1024)),
               "directories": Shaped((16, 1 << 14)),
               "global_depths": Shaped((16,))}
        one = {"data": 1, "model": 1}
        got = shd.sharded_eh_specs(ops, one)
        assert got == {"keys": spec("data"),
                       "directories": spec("data", "model"),
                       "global_depths": spec()}
        for mesh in (MESH, MESH3):
            want = {k: jshd.logical_spec(v.shape, jshd.EH_LOOKUP_NAMES[k],
                                         FakeMesh(mesh))
                    for k, v in ops.items()}
            assert shd.sharded_eh_specs(ops, mesh) \
                == {k: tuple(v) for k, v in want.items()}
        assert shd.EH_LOOKUP_NAMES == jshd.EH_LOOKUP_NAMES


class TestKVViewSpecs:
    NAMES = ("kv_shard", "layer", "kv_seqs", "ctx", "kv_heads", "head_dim")

    def test_stacked_view_names(self):
        assert shd.logical_spec((16, 4, 64, 128, 16, 128), self.NAMES,
                                MESH) == spec("data", None, None, None,
                                              "model")

    def test_indivisible_shards_replicate(self):
        assert shd.logical_spec((2, 4, 64, 128, 16, 128), self.NAMES,
                                MESH) == spec(None, None, "data", None,
                                              "model")

    def test_sharded_kv_view_specs_helper(self):
        class Shaped:
            def __init__(self, shape):
                self.shape = shape
        shape = (8, 2, 4, 32, 2, 8)
        got = shd.sharded_kv_view_specs(
            {"view_k": Shaped(shape), "view_v": Shaped(shape)},
            {"data": 1, "model": 1})
        assert got["view_k"] == spec("data", None, None, None, "model")
        assert got["view_v"] == got["view_k"]
        assert shd.KV_VIEW_NAMES == jshd.KV_VIEW_NAMES


class TestParamNames:
    def test_names_cover_all_leaves(self):
        names = shd.param_names(param_struct(get("hymba_1_5b").reduced()))
        leaves = flat(param_struct(get("hymba_1_5b").reduced()))
        got = flat(names, leaf=lambda x: isinstance(x, list))
        assert got.keys() == leaves.keys()
        for k, p in leaves.items():
            assert len(got[k]) == p.dim()


def flat(tree, prefix="", leaf=lambda x: not isinstance(x, dict)):
    """{key path: leaf} of nested dictionaries."""
    if leaf(tree):
        return {prefix.rstrip("/"): tree}
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}{k}/", leaf))
    return out


def jax_flat(tree, leaf=None):
    pairs, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)
    return {jshd._path_str(path): x for path, x in pairs}


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_specs_match_jax(arch):
    """Every leaf's names and spec, both production meshes, full size."""
    j_struct = j_param_struct(jget(arch), jnp.bfloat16)
    j_names = jax_flat(jshd.param_names(j_struct),
                       leaf=lambda x: isinstance(x, list))
    j_shapes = jax_flat(j_struct)
    p_struct = param_struct(get(arch), torch.bfloat16)
    names = flat(shd.param_names(p_struct),
                 leaf=lambda x: isinstance(x, list))
    assert names == j_names
    assert {k: tuple(v.shape) for k, v in flat(p_struct).items()} \
        == {k: tuple(v.shape) for k, v in j_shapes.items()}
    for mesh in (MESH, MESH3):
        got = flat(shd.param_specs(p_struct, mesh),
                   leaf=lambda x: isinstance(x, tuple))
        want = {k: tuple(jshd.logical_spec(j_shapes[k].shape, n,
                                           FakeMesh(mesh)))
                for k, n in j_names.items()}
        assert got == want


@pytest.mark.parametrize("arch", ASSIGNED)
def test_decode_state_and_batch_specs_match_jax(arch):
    cfg, jcfg = get(arch), jget(arch)
    for shape in ("decode_32k", "long_500k"):
        B, S = SHAPES[shape].global_batch, SHAPES[shape].seq_len
        j_struct = j_state_struct(jcfg, B, S)
        j_names = j_state_names(jcfg)
        struct = serve.decode_state_struct(cfg, B, S)
        for mesh in (MESH, MESH3):
            got = serve.decode_state_specs(cfg, struct, mesh)
            for g, s, n in zip(got, j_struct, j_names):
                if n == ():
                    assert g == ()
                else:
                    assert g == tuple(jshd.logical_spec(s.shape, n,
                                                        FakeMesh(mesh)))
    for shape in ("train_4k", "prefill_32k"):
        B, S = SHAPES[shape].global_batch, SHAPES[shape].seq_len
        batch = input_specs(cfg, shape)["batch"]
        j_batch = j_batch_specs(jcfg, S, B)
        for mesh in (MESH, MESH3):
            got = shd.batch_spec(batch, mesh)
            want = {k: tuple(jshd.logical_spec(
                v.shape, ["batch"] + [None] * (len(v.shape) - 1),
                FakeMesh(mesh))) for k, v in j_batch.items() if k in batch}
            assert got == want


def test_shardings_for_and_replicated():
    cfg = get("hymba_1_5b").reduced()
    struct = serve.decode_state_struct(cfg, 16, 64)
    got = shd.shardings_for(struct, serve.decode_state_names(cfg), MESH)
    assert got == serve.decode_state_specs(cfg, struct, MESH)
    assert got.ctx_len == spec("data")
    assert shd.replicated(MESH) == spec()
    rules = shd.ShardingRules({"batch": (("model",),)})
    assert shd.logical_spec((32,), ("batch",), MESH, rules) == spec("model")
    assert shd.default_rules(MESH3).candidates("batch")[0] == ("pod", "data")
