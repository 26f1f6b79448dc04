"""Phi-4-mini (3.8B) [arXiv:2412.08905; hf].

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064; RoPE (partial
rotary 0.75), SwiGLU, tied embeddings.
"""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    mlp_act="swiglu",
    rope_theta=1e4,
    partial_rotary=0.75,
    tie_embeddings=True,
    max_seq_len=131072,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, max_seq_len=512,
    )
