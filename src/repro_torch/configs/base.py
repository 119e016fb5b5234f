"""Architecture configuration system (a copy of ``repro/configs/base.py``:
the port imports nothing of the JAX package).

``ArchConfig`` is a frozen dataclass describing one LM backbone; every
assigned architecture registers an instance via :func:`register` in its own
``configs/<id>.py``.  ``reduced()`` derives the CPU smoke-test variant
(same family/topology, tiny dims).  ``get(name)`` / ``list_archs()`` are the
public registry API used by the launcher (``--arch <id>``).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional

_REGISTRY: dict[str, "ArchConfig"] = {}

#: assigned architecture ids (public pool), imported lazily by get()
ASSIGNED = (
    "arctic_480b", "qwen2_moe_a2_7b", "mamba2_370m", "command_r_plus_104b",
    "internlm2_1_8b", "qwen3_4b", "gemma2_27b", "musicgen_medium",
    "paligemma_3b", "hymba_1_5b",
)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                   # 0 for attention-free
    num_kv_heads: int
    d_ff: int                        # dense MLP hidden (0 = no dense MLP)
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // num_heads

    # attention details
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    local_global_period: int = 0     # gemma2: every p-th layer is global
    global_layers: tuple = ()        # hymba: explicit global layer ids
    rope_theta: float = 10000.0
    attn_bias: bool = False
    # mesh-divisibility head padding (activation-level, mathematically
    # inert: dead q-heads are zero -> their outputs are sliced off before
    # wo; dead kv-groups receive only dead q-heads).  0 = no padding.
    pad_kv_heads: int = 0        # pad num_kv_heads to this
    pad_q_groups: int = 0        # pad per-kv q-group size to this

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    dense_residual: bool = False     # arctic: dense FFN parallel to MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # modality frontend (audio/vlm backbones get precomputed embeddings)
    input_mode: str = "tokens"       # tokens | embeddings | prefix_embeddings
    prefix_len: int = 0              # paligemma: image patch tokens

    tie_embeddings: bool = False
    act: str = "silu"
    norm_eps: float = 1e-6
    loss_chunk: int = 2048           # chunked cross-entropy (memory control)
    attn_chunk_q: int = 2048         # blockwise-attention tile sizes
    attn_chunk_kv: int = 1024

    # -- derived -------------------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def has_attention(self) -> bool:
        return self.num_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k: no *unwindowed* attention layer...
        pure SSM, or hybrid whose attention is sliding-window except a
        bounded set of global layers (hymba) — decode stays O(window + g)."""
        if not self.has_attention:
            return True
        return self.has_ssm and self.sliding_window is not None

    def num_params(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        n = self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            n += d * self.vocab_size                 # lm head
        per = 0
        if self.has_attention:
            per += d * (self.num_heads * hd) * 2     # wq, wo
            per += d * (self.num_kv_heads * hd) * 2  # wk, wv
            if self.qk_norm:
                per += 2 * hd
        if self.has_ssm:
            di, ns, nh = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            per += d * (2 * di + 2 * ns + nh)        # in_proj
            per += di * d                            # out_proj
            per += (di + 2 * ns) * self.ssm_conv     # conv
            per += 3 * nh + di                       # A, D, dt_bias, norm
        if self.d_ff:
            per += 3 * d * self.d_ff                 # SwiGLU
        if self.num_experts:
            per += d * self.num_experts              # router
            per += self.num_experts * 3 * d * self.moe_d_ff
            if self.shared_d_ff:
                per += 3 * d * self.shared_d_ff
        per += 2 * d                                 # ln1, ln2
        return n + per * L + d                       # + final norm

    def num_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.num_experts:
            return self.num_params()
        dense = dataclasses.replace(
            self, num_experts=0, top_k=0, moe_d_ff=0, shared_d_ff=0)
        active_moe = (self.top_k * 3 * self.d_model * self.moe_d_ff
                      + 3 * self.d_model * self.shared_d_ff
                      + self.d_model * self.num_experts) * self.num_layers
        return dense.num_params() + active_moe

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        def cap(v, m):
            return min(v, m) if v else v
        return dataclasses.replace(
            self,
            num_layers=min(self.num_layers, 2),
            d_model=cap(self.d_model, 64),
            num_heads=cap(self.num_heads, 4),
            num_kv_heads=cap(self.num_kv_heads, 2),
            head_dim=16 if self.num_heads else 0,
            d_ff=cap(self.d_ff, 128),
            vocab_size=cap(self.vocab_size, 256),
            num_experts=cap(self.num_experts, 8),
            top_k=cap(self.top_k, 2),
            moe_d_ff=cap(self.moe_d_ff, 64),
            num_shared_experts=cap(self.num_shared_experts, 1),
            shared_d_ff=cap(self.shared_d_ff, 64),
            # ample capacity: reduced-config tests compare decode vs full
            # forward, which must not differ by capacity dropping
            capacity_factor=8.0,
            pad_kv_heads=0, pad_q_groups=0,  # no padding at toy sizes
            ssm_state=cap(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16 if self.ssm_state else 128,
            sliding_window=cap(self.sliding_window, 32),
            global_layers=tuple(g for g in self.global_layers if g < 2),
            prefix_len=cap(self.prefix_len, 8),
            loss_chunk=64,
            attn_chunk_q=32,
            attn_chunk_kv=32,
        )


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{key}")
    return _REGISTRY[key]


def list_archs() -> list[str]:
    for key in ASSIGNED:
        if key not in _REGISTRY:
            importlib.import_module(f"repro_torch.configs.{key}")
    return sorted(_REGISTRY)
