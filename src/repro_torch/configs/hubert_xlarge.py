"""HuBERT X-Large [arXiv:2106.07447].

48L d_model=1280 16H d_ff=5120, 504 masked-prediction classes
(encoder-only, bidirectional; same block as wav2vec2).  The CNN waveform
frontend is a stub — ``input_specs`` feeds precomputed frame embeddings.

Adaptation note (DESIGN.md): the conv positional embedding is replaced by
bidirectional RoPE, which preserves relative-position behaviour and is the
TPU-idiomatic choice.
"""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    mlp_act="gelu",
    causal=False,
    rope_theta=1e4,
    max_seq_len=32768,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=64, max_seq_len=512,
    )
