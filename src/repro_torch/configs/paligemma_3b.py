"""PaliGemma-3B: SigLIP vision frontend (stubbed — input_specs() provides
precomputed patch embeddings as a 256-token prefix) + Gemma-2B decoder
(MQA, head_dim 256). [arXiv:2407.07726]"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="paligemma_3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    d_ff=16384, vocab_size=257216, head_dim=256,
    input_mode="prefix_embeddings", prefix_len=256,
    act="gelu", tie_embeddings=True,
    pad_q_groups=16,  # MQA: 8 q-heads -> 16 for the model axis
))
