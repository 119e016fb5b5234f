"""Qwen1.5-MoE-A2.7B: 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="qwen2_moe_a2_7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=0, vocab_size=151936, head_dim=128,
    num_experts=60, top_k=4, moe_d_ff=1408,
    num_shared_experts=4, shared_d_ff=5632,
    rope_theta=1000000.0, attn_bias=True,
))
