"""Gemma-3-27B [hf:google/gemma-3-*-pt].

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144; 5:1
local(sliding-window 1024):global attention, dual RoPE theta (10k local /
1M global), gemma-style (1+w) RMSNorm with pre+post block norms, QK-norm,
128k context.
"""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    mlp_act="geglu",
    gemma_norm=True,
    use_qk_norm=True,
    tie_embeddings=True,
    rope_theta=1e4,
    rope_theta_global=1e6,
    sliding_window=1024,
    global_every=6,
    max_seq_len=131072,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, sliding_window=32, global_every=6,
        max_seq_len=512,
    )
