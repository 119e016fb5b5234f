"""MusicGen-medium: decoder-only transformer over EnCodec tokens; the
EnCodec frontend is a stub — input_specs() provides precomputed frame
embeddings. [arXiv:2306.05284]"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="musicgen_medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    input_mode="embeddings", act="gelu",
    pad_kv_heads=32,  # 24 MHA heads -> 32 for the 16-way model axis
))
