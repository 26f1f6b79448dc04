"""Smoke-size model sections and mixes of the benchmark's cells: the same
families and paths at widths the CPU runs in seconds."""
import copy

import traffic

ZAMBA2 = dict(name="zamba2-1.2b", family="hybrid", n_layers=8, d_model=64,
              n_heads=4, n_kv_heads=4, head_dim=32, d_ff=128, vocab_size=256,
              mlp_act="geglu", norm_eps=1e-5, rope_theta=1e4,
              ssm=dict(d_state=16, d_conv=4, expand=2, head_dim=16,
                       n_groups=1, chunk=32),
              hybrid_attn_every=3, max_seq_len=512, dtype="bfloat16")
GLM4 = dict(name="glm4-9b", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, head_dim=16, d_ff=192, vocab_size=256,
            mlp_act="swiglu", norm_eps=1e-5, rope_theta=1e4,
            partial_rotary=0.5, max_seq_len=512, dtype="bfloat16")
MODELS = {"zamba2-1.2b": ZAMBA2, "glm4-9b": GLM4}


def model(config: str, dtype: str = "bfloat16") -> dict:
    m = copy.deepcopy(MODELS[config])
    m["dtype"] = dtype
    return m


def mix(name: str) -> dict:
    m = traffic.load(name)
    m.update(batch=2, seq_len=96)
    if m["kind"] == "prefill":
        m["check_requests"] = 3
    return m
