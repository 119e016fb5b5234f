"""Gemma2-27B: local(4096-window)/global alternating attention, attn+final
logit softcaps, GQA. [arXiv:2408.00118]"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="gemma2_27b", family="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16,
    d_ff=36864, vocab_size=256000, head_dim=128,
    sliding_window=4096, local_global_period=2,
    attn_softcap=50.0, final_softcap=30.0, act="gelu",
    tie_embeddings=True,
))
