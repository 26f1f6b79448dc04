"""Mamba2-780m [arXiv:2405.21060].

48L d_model=1536, attention-free SSD blocks, ssm_state=128, vocab=50280;
expand=2 (d_inner 3072), head_dim 64 (48 SSD heads), chunked scan.
"""
import dataclasses

from repro_torch.models.common import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    max_seq_len=1048576,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab_size=256,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1,
                      chunk=32),
        max_seq_len=512,
    )
