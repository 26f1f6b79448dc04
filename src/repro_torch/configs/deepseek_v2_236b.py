"""DeepSeek-V2 (236B, 21B active) [arXiv:2405.04434; hf].

60L d_model=5120 128H, MLA (kv_lora=512, q_lora=1536, rope split 128+64),
d_ff(expert)=1536, vocab=102400; MoE: 2 shared + 160 routed experts top-6,
first layer dense (d_ff 12288), routed scaling 16.
"""
import dataclasses

from repro_torch.models.common import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=1536,
    vocab_size=102400,
    mlp_act="swiglu",
    rope_theta=1e4,
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=160,
        top_k=6,
        d_expert=1536,
        n_shared=2,
        d_shared=1536,
        first_dense_layers=1,
        d_first_dense=12288,
        router_scale=16.0,
    ),
    max_seq_len=131072,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=32, vocab_size=256,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                      d_shared=32, first_dense_layers=1, d_first_dense=64,
                      router_scale=4.0),
        max_seq_len=512,
    )
