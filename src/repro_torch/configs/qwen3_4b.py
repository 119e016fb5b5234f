"""Qwen3-4B: GQA + qk_norm dense. [hf:Qwen/Qwen3-8B family]"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="qwen3_4b", family="dense",
    num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=9728, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1000000.0, tie_embeddings=True,
))
