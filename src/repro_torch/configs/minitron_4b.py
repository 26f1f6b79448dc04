"""Minitron-4B (pruned Nemotron) [arXiv:2407.14679; hf].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000; squared-ReLU MLP
(Nemotron family), partial rotary 0.5.
"""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    mlp_act="relu2",
    rope_theta=1e4,
    partial_rotary=0.5,
    max_seq_len=4096,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, max_seq_len=512,
    )
