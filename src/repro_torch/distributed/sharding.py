"""Divisibility-aware logical-axis sharding rules (twin of
``repro/distributed/sharding.py``), as pure Python over an abstract mesh.

Every array carries *logical* dimension names; the rules map them onto
physical mesh axes.  Each logical name lists candidate mesh axes (or axis
tuples) in priority order, and the first candidate whose size divides the
dimension, and whose axes no other dimension of the array has taken, wins;
a dimension with no such candidate is replicated.  Default intent on the
production mesh ``(pod, data, model)``:

  batch       -> (pod, data)      data parallelism
  vocab/ff/heads/expert -> model  tensor parallelism
  embed       -> data             FSDP (weights sharded over the DP axis)
  ctx         -> model            decode-time sequence parallelism, when
                                  kv_heads cannot take ``model``

A mesh here is an ordered mapping from axis name to size
(``{"data": 16, "model": 16}``); no device stands behind it.  A spec is a
tuple with a ``PartitionSpec``'s entries: ``None`` (replicated), an axis
name, or a tuple of axis names combined; trailing ``None``s are dropped, so
a replicated array's spec is ``()``.

One card has no mesh: the port computes these specs for parity with the
reference (``runtime/serve.decode_state_specs``, the tests), and nothing in
the port places a tensor by them.  The reference's
``activate_mesh`` and ``constrain`` are not imitated: they pin
intermediates for the GSPMD partitioner, and one card has none
(``models/model.py``, ``models/moe.py``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence, Union

Axis = Union[str, tuple]
Spec = tuple


@dataclass(frozen=True)
class ShardingRules:
    """Logical name -> candidate physical axes (priority ordered)."""

    rules: dict = field(default_factory=dict)

    def candidates(self, name: Optional[str]) -> Sequence[Axis]:
        if name is None:
            return ()
        return self.rules.get(name, ())


def default_rules(mesh: Mapping[str, int]) -> ShardingRules:
    """The production rule set; it adapts to whether a ``pod`` axis
    exists."""
    dp: tuple = ("pod", "data") if "pod" in mesh else ("data",)
    return ShardingRules(rules={
        # data dims
        "batch": (dp, ("data",)),
        "seq": (),                       # train seq stays unsharded
        "ctx": (("model",), ("data",)),  # decode context (SP fallback)
        # weight dims
        "vocab": (("model",),),
        "embed": (("data",),),           # FSDP axis
        "heads": (("model",),),
        "kv_heads": (("model",),),
        "ff": (("model",),),
        "expert": (("model",), ("data",)),
        "ssm_inner": (("model",),),
        "ssm_heads": (("model",),),
        # serving dims
        "kv_seqs": (dp, ("data",)),      # sequences in the KV pool
        "blocks": (dp, ("data",)),       # physical KV blocks
        "head_dim": (("model",),),       # last-resort pool sharding
        # the sharded EH index (core/sharded_eh): shards stacked on a
        # leading `eh_shard` dim, one a data slice; directory and bucket
        # pool over the model axis; a bucket row (`eh_slots`) is probed as
        # one vector and never splits
        "eh_shard": (dp, ("data",)),
        "eh_dir": (("model",), ("data",)),
        "eh_buckets": (("model",), ("data",)),
        "eh_slots": (),
        # per-shard KV views (kvcache/shortcut_cache, num_shards=N)
        "kv_shard": (dp, ("data",)),
        # generic replicated
        "layer": (),
    })


def _axis_size(mesh: Mapping[str, int], axis: Axis) -> int:
    n = 1
    for a in _axis_names(axis):
        n *= mesh[a]
    return n


def _axis_names(axis: Axis) -> tuple:
    return axis if isinstance(axis, tuple) else (axis,)


#: dims with a higher number claim physical axes later: ``ctx`` is the
#: decode sequence-parallel *fallback* and must not take the model axis
#: from a divisible kv_heads/heads dim
_NAME_PRIORITY = {"ctx": 5, "head_dim": 9}


def logical_spec(shape: Sequence[int], names: Sequence[Optional[str]],
                 mesh: Mapping[str, int],
                 rules: Optional[ShardingRules] = None) -> Spec:
    """The spec of an array of ``shape`` whose dims are named ``names``.

    Greedy in name-priority order (tensor-parallel dims before the
    sequence-parallel fallbacks); each physical axis is taken at most once
    per array; a dim whose candidates all fail divisibility is replicated.
    """
    rules = rules or default_rules(mesh)
    if len(shape) != len(names):
        raise ValueError(f"shape {tuple(shape)} and names {tuple(names)} "
                         "differ in length")
    used: set = set()
    entries: list = [None] * len(shape)
    order = sorted(range(len(shape)),
                   key=lambda i: (_NAME_PRIORITY.get(names[i], 0), i))
    for i in order:
        dim, name = shape[i], names[i]
        for cand in rules.candidates(name):
            ax = _axis_names(cand)
            if any(a not in mesh or a in used for a in ax):
                continue
            if dim == 0 or dim % _axis_size(mesh, cand) != 0:
                continue
            entries[i] = cand if isinstance(cand, tuple) and len(cand) > 1 \
                else ax[0]
            used.update(ax)
            break
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _is_names(x) -> bool:
    return isinstance(x, list) or (isinstance(x, tuple)
                                   and not hasattr(x, "_fields"))


def shardings_for(tree, names_tree, mesh: Mapping[str, int],
                  rules: Optional[ShardingRules] = None):
    """Specs for a tree (dictionaries, NamedTuples) of tensors, from a
    parallel tree whose leaves are name lists; an empty member (``()``)
    stays ``()``."""
    if isinstance(tree, dict):
        return {k: shardings_for(v, names_tree[k], mesh, rules)
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*[shardings_for(v, n, mesh, rules)
                            for v, n in zip(tree, names_tree)])
    if isinstance(tree, tuple) and not tree:
        return ()
    if not _is_names(names_tree):
        raise ValueError(f"no names for the leaf of shape {tuple(tree.shape)}")
    return logical_spec(tree.shape, names_tree, mesh, rules)


# ---------------------------------------------------------------------------
# Path-based parameter naming.
# ---------------------------------------------------------------------------

# (path regex, logical names for the *trailing* dims; a leading stacked layer
#  dim is prefixed with "layer").  First match wins.
_PARAM_NAME_RULES: list[tuple[str, tuple]] = [
    (r"embed$", ("vocab", "embed")),
    (r"lm_head$", ("embed", "vocab")),
    (r"attn/wq$", ("embed", "heads")),
    (r"attn/wk$", ("embed", "kv_heads")),
    (r"attn/wv$", ("embed", "kv_heads")),
    (r"attn/wo$", ("heads", "embed")),
    (r"attn/(q_norm|k_norm)$", (None,)),
    (r"mlp/wi$", ("embed", "ff")),
    (r"mlp/wo$", ("ff", "embed")),
    (r"moe/router$", ("embed", "expert")),
    (r"moe/wi$", ("expert", "embed", "ff")),
    (r"moe/wo$", ("expert", "ff", "embed")),
    (r"moe/shared/wi$", ("embed", "ff")),
    (r"moe/shared/wo$", ("ff", "embed")),
    (r"ssm/in_proj$", ("embed", "ssm_inner")),
    (r"ssm/out_proj$", ("ssm_inner", "embed")),
    (r"ssm/conv_w$", (None, "ssm_inner")),
    (r"ssm/conv_b$", ("ssm_inner",)),
    (r"ssm/(A_log|D|dt_bias)$", ("ssm_heads",)),
    (r"ssm/norm$", ("ssm_inner",)),
    (r"(ln1|ln2|final_norm|norm)$", (None,)),
]


def _leaf_names(path: str, ndim: int) -> list:
    stacked = path.startswith("layers/")
    for pat, names in _PARAM_NAME_RULES:
        if re.search(pat, path):
            full = (("layer",) if stacked else ()) + names
            if len(full) <= ndim:
                return list(full) + [None] * (ndim - len(full))
            return list(full[:ndim])
    return [None] * ndim


def param_names(params: dict, _prefix: str = "") -> dict:
    """Logical-name lists parallel to a parameter dictionary, from each
    leaf's key path (``"layers/attn/wq"``)."""
    return {k: param_names(v, f"{_prefix}{k}/") if isinstance(v, dict)
            else _leaf_names(f"{_prefix}{k}", v.dim())
            for k, v in params.items()}


def param_specs(params: dict, mesh: Mapping[str, int],
                rules: Optional[ShardingRules] = None) -> dict:
    """Specs parallel to a parameter dictionary (tensors or meta
    tensors)."""
    return shardings_for(params, param_names(params), mesh, rules)


def batch_spec(batch: dict, mesh: Mapping[str, int],
               rules: Optional[ShardingRules] = None) -> dict:
    """Every batch member sharded on its leading (batch) dim only."""
    return {k: logical_spec(x.shape, ["batch"] + [None] * (x.dim() - 1),
                            mesh, rules)
            for k, x in batch.items()}


def replicated(mesh: Mapping[str, int]) -> Spec:
    """The spec of a replicated array on ``mesh``: no entries."""
    return ()


#: Logical names of the stacked sharded-EH lookup operands
#: (``core/sharded_eh.ShardedShortcutEH.lookup_batched``).
EH_LOOKUP_NAMES = {
    "keys": ("eh_shard", None),                      # (N, K)
    "directories": ("eh_shard", "eh_dir"),           # (N, D)
    "bucket_keys": ("eh_shard", "eh_buckets", "eh_slots"),   # (N, C, S)
    "bucket_vals": ("eh_shard", "eh_buckets", "eh_slots"),
    "view_keys": ("eh_shard", "eh_dir", "eh_slots"),         # (N, V, S)
    "view_vals": ("eh_shard", "eh_dir", "eh_slots"),
    "global_depths": (None,),                        # (N,) tiny: replicate
}


def sharded_eh_specs(operands: dict, mesh: Mapping[str, int],
                     rules: Optional[ShardingRules] = None) -> dict:
    """Specs of sharded-EH lookup operands keyed by their
    :data:`EH_LOOKUP_NAMES` names; indivisible dims replicate."""
    return {k: logical_spec(v.shape, EH_LOOKUP_NAMES[k], mesh, rules)
            for k, v in operands.items()}


#: Logical names of the stacked per-shard KV views
#: (``kvcache/shortcut_cache.ShortcutKVManager`` with ``num_shards=N``):
#: each shard's (L, seqs_per_shard, S_cap, KV, hd) pair stacked on a leading
#: ``kv_shard`` dim.
KV_VIEW_NAMES = {
    "view_k": ("kv_shard", "layer", "kv_seqs", "ctx", "kv_heads",
               "head_dim"),
    "view_v": ("kv_shard", "layer", "kv_seqs", "ctx", "kv_heads",
               "head_dim"),
}


def sharded_kv_view_specs(operands: dict, mesh: Mapping[str, int],
                          rules: Optional[ShardingRules] = None) -> dict:
    """Specs of stacked per-shard KV views keyed by their
    :data:`KV_VIEW_NAMES` names; indivisible dims replicate."""
    return {k: logical_spec(v.shape, KV_VIEW_NAMES[k], mesh, rules)
            for k, v in operands.items()}
