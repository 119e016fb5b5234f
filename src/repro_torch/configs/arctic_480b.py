"""Snowflake Arctic base: dense-MoE hybrid — a dense FFN residual runs in
parallel with a 128-expert top-2 MoE every layer. [hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="arctic_480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000, head_dim=128,
    num_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
    # 56 q-heads don't divide the 16-way model axis: pad groups 7->8
    # (H 56->64, mathematically inert; EXPERIMENTS.md §Perf iter 6)
    pad_q_groups=8,
))
