"""Operations and bytes of a served decoder, from its configuration's
``model`` sizes alone: the yardstick of ``step_mfu.*`` and the kernels'
roofline shares.

Model FLOPs count a multiply-add as 2: every matrix product a token needs
(attention, SSM and MLP projections, the router, the top-k experts and the
shared expert, and the output head for each position whose logits are
computed), attention's Q K^T and P V over the keys each token sees (its
window on a local layer), and the SSM's recurrence (6 FLOPs a state
element: decay, input and read-out) and causal conv.  They count what the
model needs, not what a kernel happens to do: a dropped MoE pair and the
SSD's intra-chunk products do not change them.
"""
from __future__ import annotations


def attn_windows(m: dict) -> list:
    """Each layer's attention window: None (global) or its width; [] for a
    model with no attention."""
    if not m.get("num_heads"):
        return []
    L, w = m["num_layers"], m.get("sliding_window")
    if w is None:
        return [None] * L
    glob = set(m.get("global_layers", ()))
    if not glob:
        return [w] * L
    return [None if i in glob else w for i in range(L)]


def visible_keys(pos: int, window) -> int:
    """Keys a token at position ``pos`` attends, itself included."""
    return pos + 1 if window is None else min(pos + 1, window)


def prefill_pairs(S: int, window) -> int:
    """(query, key) pairs of a causal prefill of ``S`` positions."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def layer_params(m: dict) -> int:
    """Matrix parameters one token multiplies by in one layer."""
    D = m["d_model"]
    n = 0
    if m.get("num_heads"):
        hd = m["head_dim"]
        n += 2 * D * hd * (m["num_heads"] + m["num_kv_heads"])
    if m.get("ssm_state"):
        di, N = m["ssm_expand"] * D, m["ssm_state"]
        n += D * (2 * di + 2 * N + di // m["ssm_head_dim"]) + di * D
    if m.get("d_ff"):
        n += 3 * D * m["d_ff"]
    if m.get("num_experts"):
        n += D * m["num_experts"] + m["top_k"] * 3 * D * m["moe_d_ff"]
        n += 3 * D * m.get("shared_d_ff", 0)
    return n


def ssm_token_flops(m: dict) -> int:
    """One token's SSM recurrence and causal conv, all layers."""
    if not m.get("ssm_state"):
        return 0
    di, N = m["ssm_expand"] * m["d_model"], m["ssm_state"]
    conv_dim = di + 2 * N
    return m["num_layers"] * (6 * di * N + 2 * conv_dim * m["ssm_conv"])


def attn_flops(m: dict, keys_per_layer) -> int:
    """Q K^T and P V of one query token over ``keys_per_layer`` keys."""
    if not m.get("num_heads"):
        return 0
    return sum(4 * m["num_heads"] * m["head_dim"] * k for k in keys_per_layer)


def prefill_flops(m: dict, batch: int, S: int) -> int:
    """A prefill of ``batch`` prompts of ``S`` tokens, the last position's
    logits computed."""
    proj = 2 * S * m["num_layers"] * layer_params(m)
    attn = sum(4 * m["num_heads"] * m["head_dim"] * prefill_pairs(S, w)
               for w in attn_windows(m))
    head = 2 * m["d_model"] * m["vocab_size"]
    return batch * (proj + attn + S * ssm_token_flops(m) + head)


def decode_flops(m: dict, batch: int, pos: int) -> int:
    """One decode step of ``batch`` sequences whose new token sits at
    position ``pos`` (``pos`` tokens already cached)."""
    proj = 2 * m["num_layers"] * layer_params(m)
    attn = attn_flops(m, [visible_keys(pos, w) for w in attn_windows(m)])
    head = 2 * m["d_model"] * m["vocab_size"]
    return batch * (proj + attn + ssm_token_flops(m) + head)


def flash_flops(m: dict, batch: int, S: int) -> int:
    """The prefill attention kernel's work over all layers: 4 hd FLOPs a
    query head for each visible (query, key) pair."""
    if not m.get("num_heads"):
        return 0
    return sum(4 * batch * m["num_heads"] * m["head_dim"]
               * prefill_pairs(S, w) for w in attn_windows(m))


def decode_attn_bytes(m: dict, batch: int, pos: int, itemsize: int) -> int:
    """The decode attention kernels' bytes in one step over all layers, as
    few as the step needs: each visible K and V row read once (the new
    token's own included), q read and the output written, the lengths
    read."""
    if not m.get("num_heads"):
        return 0
    KV, H, hd = m["num_kv_heads"], m["num_heads"], m["head_dim"]
    total = 0
    for w in attn_windows(m):
        rows = visible_keys(pos, w)
        total += batch * (2 * rows * KV * hd * itemsize
                          + 2 * H * hd * itemsize + 4)
    return total
