"""Mixtral-8x7B [arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000; 8 experts top-2
(renormalized gates), sliding-window attention (4096).
"""
import dataclasses

from repro_torch.models.common import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    mlp_act="swiglu",
    rope_theta=1e6,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=14336),
    max_seq_len=131072,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, sliding_window=64,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=128),
        max_seq_len=512,
    )
