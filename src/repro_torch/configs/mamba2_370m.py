"""Mamba2-370m: attention-free SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="mamba2_370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    tie_embeddings=True,
))
