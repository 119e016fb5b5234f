"""InternLM2-1.8B: GQA dense. [arXiv:2403.17297]"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="internlm2_1_8b", family="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92544, head_dim=128, rope_theta=1000000.0,
))
