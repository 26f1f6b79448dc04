"""Qwen2-VL-2B backbone [arXiv:2409.12191; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.  M-RoPE with
(temporal, height, width) frequency sections (16, 24, 24); the vision
frontend is a stub — ``input_specs`` feeds precomputed patch embeddings.
"""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    mlp_act="swiglu",
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    tie_embeddings=True,
    max_seq_len=32768,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, mrope_sections=(2, 3, 3), max_seq_len=512,
    )
