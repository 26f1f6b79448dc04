"""Zamba2-1.2B [arXiv:2411.15242; hf].

38L d_model=2048: Mamba2 backbone (ssm_state=64) with a *shared* global
attention block (32H) every 6 layers (shared weights, per-site KV cache),
d_ff=8192 on the attention sites, vocab=32000.
"""
import dataclasses

from repro_torch.models.common import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    mlp_act="swiglu",
    rope_theta=1e4,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    hybrid_attn_every=6,
    max_seq_len=1048576,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, hybrid_attn_every=3,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1,
                      chunk=32),
        max_seq_len=512,
    )
