"""The frozen work arithmetic against hand counts on small shapes, and
every share it yields at or under 100% on the times the records hold."""
import json
from pathlib import Path

import pytest

import arith
from families import decoder as family

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _model(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["model"]


def test_attention_counts_the_visible_pairs_by_hand():
    # 1 row, 3 tokens causal: pairs (0,0) (1,0) (1,1) (2,0) (2,1) (2,2) = 6
    assert arith.visible_pairs(3, 3, True) == 6
    assert arith.visible_pairs(3, 5, False) == 15
    flops, n_bytes = arith.attention_work(1, 3, 3, 2, 1, 4, 4, 2)
    assert flops == 2 * 6 * 2 * (4 + 4)
    # q 24, k 12, v 12, out 24 elements of 2 bytes; 6 int32 positions
    assert n_bytes == (24 + 12 + 12 + 24) * 2 + 4 * 6
    bflops, bbytes = arith.attention_work(1, 3, 3, 2, 1, 4, 4, 2,
                                          backward=True)
    assert bflops == 2 * 6 * 2 * (3 * 4 + 2 * 4)
    assert bbytes == (2 * (24 + 12 + 12) + 2 * 24) * 2 + 4 * 6 + 4 * 6
    with pytest.raises(ValueError):
        arith.visible_pairs(2, 3, True)


def test_ssd_counts_by_hand():
    # one chunk of 2 steps, 1 head, p = n = 1: tri = 3
    # C.B^T 2*3*1, per head 2*3*1 + 4*2*1*1 + 3*3 = 23
    assert arith.ssd_forward_flops(1, 2, 1, 1, 1, 2) == 2 * 3 + 23
    assert arith.ssd_forward_flops(2, 4, 1, 1, 1, 2) == 2 * 2 * (2 * 3 + 23)
    flops, n_bytes = arith.ssd_work(1, 2, 1, 1, 1, 2, 2)
    # x 2 and y 2, B 2 and C 2 (2 bytes); dt 2, a 1, final state 1 (fp32)
    assert n_bytes == (2 + 2 + 2 + 2) * 2 + 4 * (2 + 1 + 1)
    bflops, _ = arith.ssd_work(1, 2, 1, 1, 1, 2, 2, backward=True)
    assert bflops == 2 * flops


def test_model_flops_count_every_matrix_once_a_site():
    m = dict(n_layers=3, d_model=4, n_heads=2, n_kv_heads=1, head_dim=2,
             d_ff=8, vocab_size=10, mlp_act="swiglu")
    per_layer = 4 * 4 + 2 * 4 * 2 + 4 * 4 + 3 * 4 * 8
    assert family.matmul_params(m) == 3 * per_layer
    fwd = family.forward_flops(m, 1, 3, head_rows=1)
    assert fwd == 2 * 3 * per_layer * 3 + 2 * 4 * 10 + \
        3 * 2 * 2 * 6 * (2 + 2)
    z = _model("zamba2-1.2b")
    kinds = family.layer_kinds(z)
    assert kinds.count("shared_attn") == 6 and kinds.count("mamba") == 32


def test_a_step_counts_three_forwards_and_a_call_its_last_rows():
    import run as bench
    import smoke
    from kinds import prefill, train

    env = bench.environment("zamba2-1.2b.train", 1, "cpu",
                            model=smoke.model("zamba2-1.2b"),
                            mix=smoke.mix("train"))
    b, s = env.mix["batch"], env.mix["seq_len"]
    assert train.Run(env).unit_flops == 3 * family.forward_flops(
        env.model, b, s, head_rows=b * s)
    env = bench.environment("glm4-9b.prefill-short", 1, "cpu",
                            model=smoke.model("glm4-9b"),
                            mix=smoke.mix("prefill-short"))
    b, s = env.mix["batch"], env.mix["seq_len"]
    assert prefill.Run(env).unit_flops == family.forward_flops(
        env.model, b, s, head_rows=b)


# (cell, op, shape, device ms of one call on the card; PERF.md's records)
RECORDED = [
    ("glm4 32k prefill_tc", arith.attention_work(1, 32768, 32768, 32, 2, 128,
                                                 128, 2), 28.7),
    ("glm4 4x2048 prefill_tc", arith.attention_work(4, 2048, 2048, 32, 2, 128,
                                                    128, 2), 0.494),
    ("zamba2 2x2048 bwd tc", arith.attention_work(2, 2048, 2048, 32, 32, 64,
                                                  64, 2, backward=True),
     1.036),
    ("zamba2 4x2048 ssd tc", arith.ssd_work(4, 2048, 64, 64, 64, 256, 2),
     0.167),
    ("zamba2 2x2048 ssd bwd tc", arith.ssd_work(2, 2048, 64, 64, 64, 256, 2,
                                                backward=True, h0=True,
                                                dfinal=True), 0.3231),
]


@pytest.mark.parametrize("name,work,ms", RECORDED, ids=[r[0] for r in RECORDED])
def test_roofline_shares_stay_under_100_on_recorded_times(name, work, ms):
    share = 100 * arith.bound_s(*work) / (ms * 1e-3)
    assert 0 < share <= 100, share


def test_mfu_stays_under_100_on_recorded_times():
    g = _model("glm4-9b")
    # 1 x 32768 prefill 2273.8 ms; 4 x 2048 275.7 ms (PERF.md section 5)
    for batch, seq, ms in ((1, 32768, 2273.8), (4, 2048, 275.7)):
        flops = family.forward_flops(g, batch, seq, head_rows=batch)
        share = 100 * flops / (ms * 1e-3) \
            / arith.PEAK_BF16_FLOPS
        assert 0 < share <= 100
