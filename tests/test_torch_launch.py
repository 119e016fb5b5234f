"""Port parity for the dry run's structs and shapes, and the serve CLI.

``launch.shapes`` (``SHAPES``, ``cell_status``, ``input_specs``),
``runtime.train.param_struct`` / ``opt_struct`` and
``runtime.serve.decode_state_struct`` / ``decode_state_names`` against the
JAX package's ``eval_shape`` structs, exactly (shapes, dtypes by name, the
tree's key paths), for every assigned architecture at full size: the
port's are meta tensors, which hold no storage.  Then
``launch.serve.main`` on the CPU at ``.reduced()`` widths on both routes.
"""
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ASSIGNED
from repro.configs import get as jget
from repro.launch import shapes as jshapes
from repro.runtime import serve as jserve
from repro.runtime.train import opt_struct as j_opt_struct
from repro.runtime.train import param_struct as j_param_struct
from repro_torch.configs import get
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import shapes
from repro_torch.runtime import serve
from repro_torch.runtime.train import opt_struct, param_struct

TORCH_DTYPE = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def jax_leaves(tree) -> dict:
    """{key path: (shape, dtype name)} of a JAX struct tree."""
    pairs, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(x.shape), jnp.dtype(x.dtype).name)
            for p, x in pairs}


def port_leaves(tree, prefix="") -> dict:
    """The same for nested dictionaries and NamedTuples of tensors, with
    JAX's key-path spelling."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(port_leaves(v, f"{prefix}['{k}']"))
    elif hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            out.update(port_leaves(v, f"{prefix}.{k}"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = (tuple(tree.shape), str(tree.dtype).split(".")[-1])
    return out


def assert_meta(tree) -> None:
    """Every leaf is a meta tensor: no storage holds its data."""
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, tuple):
            stack.extend(x)
        else:
            assert isinstance(x, torch.Tensor) and x.is_meta, x
            assert x.untyped_storage().data_ptr() == 0


def test_shape_registry_matches_jax():
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, s in shapes.SHAPES.items():
        j = jshapes.SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) \
            == (j.name, j.seq_len, j.global_batch, j.kind)
    assert shapes.SKIP == jshapes.SKIP


@pytest.mark.parametrize("arch", ASSIGNED)
def test_input_specs_and_cell_status_match_jax(arch):
    cfg, jcfg = get(arch), jget(arch)
    for shape in shapes.SHAPES:
        assert shapes.cell_status(cfg, shape) \
            == jshapes.cell_status(jcfg, shape)
        for name, dt in TORCH_DTYPE.items():
            got = shapes.input_specs(cfg, shape, dtype=dt)
            want = jshapes.input_specs(jcfg, shape, dtype=jnp.dtype(name))
            assert port_leaves(got) == jax_leaves(want), (shape, name)
            assert_meta(got)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_and_opt_structs_match_jax(arch):
    cfg, jcfg = get(arch), jget(arch)
    for name, dt in TORCH_DTYPE.items():
        p = param_struct(cfg, dt)
        jp = j_param_struct(jcfg, jnp.dtype(name))
        assert port_leaves(p) == jax_leaves(jp)
        assert_meta(p)
        for factored in (False, True):
            o = opt_struct(p, factored=factored)
            jo = j_opt_struct(jp, factored=factored)
            assert port_leaves(o) == jax_leaves(jo)
            assert_meta(o)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_decode_state_struct_and_names_match_jax(arch):
    cfg, jcfg = get(arch), jget(arch)
    for B, S in ((128, 32768), (1, 524288)):
        got = serve.decode_state_struct(cfg, B, S)
        want = jserve.decode_state_struct(jcfg, B, S)
        assert port_leaves(got) == jax_leaves(want)
        assert_meta(got)
        init = serve.decode_state_init(cfg.reduced(), 2, 8, device="cpu")
        assert port_leaves(init) == port_leaves(
            serve.decode_state_struct(cfg.reduced(), 2, 8))
    assert tuple(serve.decode_state_names(cfg)) \
        == tuple(jserve.decode_state_names(jcfg))


def run_serve(capsys, *argv):
    assert serve_cli.main(list(argv) + ["--reduced", "--device", "cpu",
                                        "--batch", "2", "--gen", "6"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4, lines
    return lines


@pytest.mark.parametrize("arch", ["qwen3_4b", "paligemma_3b"])
def test_serve_cli_routes_agree(capsys, arch):
    outs = {}
    for path in ("shortcut", "paged"):
        lines = run_serve(capsys, "--arch", arch, "--path", path)
        assert lines[0] == (f"[serve/{path}] arch={arch} B=2 prompt=32 "
                            "gen=6")
        assert lines[1].lstrip().startswith("prefill:") and "tok/s" in \
            lines[1]
        assert lines[2].lstrip().startswith("decode:") and "tok/s" in \
            lines[2]
        assert lines[3].lstrip().startswith("sample tokens[0]: [")
        outs[path] = lines[3]
    assert outs["shortcut"] == outs["paged"]
    assert len(json.loads(outs["paged"].split(": ", 1)[1])) == 6


def test_serve_cli_ssm_routes(capsys):
    """A pure-SSM model on ``--path paged`` serves on the shortcut route
    (the same tokens); a hybrid one raises, as ``make_paged_serve_step``
    does."""
    paged = run_serve(capsys, "--arch", "mamba2_370m", "--path", "paged")
    short = run_serve(capsys, "--arch", "mamba2_370m", "--path", "shortcut")
    assert paged[3] == short[3]
    with pytest.raises(NotImplementedError, match="paged route"):
        serve_cli.main(["--arch", "hymba_1_5b", "--reduced", "--device",
                        "cpu", "--path", "paged"])
