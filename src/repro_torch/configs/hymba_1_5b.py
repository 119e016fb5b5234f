"""Hymba-1.5B: hybrid heads — attention and Mamba(SSM) heads run in
*parallel* within each layer; sliding-window attention everywhere except
three global layers (first / middle / last). [arXiv:2411.13676]"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="hymba_1_5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64,
    sliding_window=1024, global_layers=(0, 15, 31),
    tie_embeddings=True,
))
