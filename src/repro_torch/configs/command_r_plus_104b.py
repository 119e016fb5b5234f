"""Cohere Command R+: GQA, no-bias dense transformer.
[hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="command_r_plus_104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=33792, vocab_size=256000, head_dim=128,
    rope_theta=75000000.0, tie_embeddings=True,
))
