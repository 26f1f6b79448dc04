"""GLM-4-9B [hf:THUDM/glm-4-9b].

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552; partial rotary
(GLM applies RoPE to half the head dim), SwiGLU.
"""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    mlp_act="swiglu",
    rope_theta=1e4,
    partial_rotary=0.5,
    max_seq_len=131072,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256, max_seq_len=512,
    )
