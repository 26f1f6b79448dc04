"""The flash kernel's routing, pinned on the CPU.

``flash_attention.variant`` is the Python twin of the C launcher's choice
among ``prefill_tc``, ``decode_split`` and ``simt`` (the launcher reports
its choice and the wrapper checks the two agree on the card;
``tests/test_torch_cuda.py`` holds the C side to it).  These tests need no
card: they pin the choice for glm4-9b's shapes, for every row of the card
tests' ``FLASH_GRID`` and at the edges of each variant.

Also the split-TF32 arithmetic of the ``simt`` forward: ``ref.tf32_split``
(the kernels' rounding of an fp32 operand into two TF32 parts) and
``ref.sdpa_x3_ref`` (the forward with every product taken as the three
split products), held here to the plain fp32 version and to the
reference's ``repro.kernels.ref.sdpa_ref`` at the f32 limits: before any
run on a card, whether split-TF32 products can meet them.
"""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from test_torch_cuda import FLASH_GRID

BF16, F32 = torch.bfloat16, torch.float32

# (dtype, Sq, Hq, Hkv, Dk, Dv) -> variant
EDGES = [
    ((BF16, 2048, 32, 2, 128, 128), "prefill_tc"),     # glm4-9b prefill
    ((BF16, 1, 32, 2, 128, 128), "decode_split"),      # glm4-9b decode
    ((BF16, 4, 32, 2, 128, 128), "decode_split"),      # 64 rows a kv head
    ((BF16, 65, 1, 1, 128, 128), "prefill_tc"),        # 65 rows
    ((BF16, 64, 2, 2, 64, 64), "decode_split"),        # 64 rows, D 64
    ((BF16, 65, 2, 2, 64, 64), "prefill_tc"),          # 65 rows, D 64
    ((BF16, 5, 32, 2, 128, 128), "prefill_tc"),        # 5 x 16 = 80 rows
    ((BF16, 128, 2, 2, 96, 96), "simt"),               # D 96
    ((BF16, 1, 16, 1, 96, 96), "simt"),                # D 96 at decode
    ((BF16, 256, 2, 2, 192, 128), "prefill_tc"),       # MLA's Dk 192, Dv 128
    ((BF16, 1, 16, 1, 192, 128), "simt"),              # MLA dims at decode
    ((BF16, 4, 16, 1, 192, 128), "simt"),              # MLA dims, 64 rows
    ((BF16, 65, 1, 1, 192, 128), "prefill_tc"),        # MLA dims, 65 rows
    ((F32, 256, 2, 2, 192, 128), "simt"),              # MLA dims in f32
    ((BF16, 256, 2, 2, 128, 192), "simt"),             # MLA's dims swapped
    ((BF16, 256, 4, 2, 128, 64), "simt"),              # Dk != Dv, both fast
    ((F32, 2048, 32, 2, 128, 128), "simt"),            # f32 prefill
    ((F32, 1, 32, 2, 128, 128), "decode_split"),       # f32 decode
    ((F32, 65, 1, 1, 64, 64), "simt"),                 # f32, 65 rows
    ((F32, 64, 1, 1, 64, 64), "decode_split"),         # f32, 64 rows
    ((BF16, 2048, 16, 16, 80, 80), "prefill_tc"),      # hubert-xlarge
    ((BF16, 64, 1, 1, 80, 80), "simt"),                # D 80, 64 rows
    ((BF16, 65, 1, 1, 80, 80), "prefill_tc"),          # D 80, 65 rows
    ((BF16, 1, 16, 16, 80, 80), "simt"),               # D 80 at decode
    ((F32, 2048, 16, 16, 80, 80), "simt"),             # D 80 in f32
    ((BF16, 256, 2, 2, 80, 64), "simt"),               # (80, 64)
    ((BF16, 256, 2, 2, 96, 96), "simt"),               # D 96: not padded
]

# FLASH_GRID row -> variant, in the grid's order
GRID_VARIANTS = [
    "simt", "simt", "simt", "simt", "simt",
    "prefill_tc",                                  # bf16 softcap, D 64
    "simt", "simt",
    "decode_split", "decode_split",                # glm4-9b decode
    "prefill_tc", "prefill_tc", "prefill_tc",      # ragged, non-causal, window
    "decode_split", "decode_split", "decode_split",
    "prefill_tc",                                  # MLA dims in bf16
    "prefill_tc", "prefill_tc", "prefill_tc",      # S 2048, ragged, padding
    "prefill_tc", "prefill_tc", "prefill_tc",      # window, softcap, GQA 2
    "prefill_tc",                                  # no causal mask
    "simt",                                        # MLA dims at decode
    "prefill_tc",                                  # hubert's forward shape
    "prefill_tc", "prefill_tc", "prefill_tc",      # causal, ragged, GQA 4
    "prefill_tc", "prefill_tc", "prefill_tc",      # GQA 4, window, padding
    "prefill_tc",                                  # softcap
    "simt", "simt",                                # D 80 in f32, at decode
]


@pytest.mark.parametrize("shape,want", EDGES)
def test_variant_at_the_edges(shape, want):
    assert fa.variant(*shape) == want


@pytest.mark.parametrize("row,want", list(zip(FLASH_GRID, GRID_VARIANTS)))
def test_variant_of_every_card_grid_row(row, want):
    b, sq, skv, hq, hkv, dk, dv, causal, window, cap, dtype, valid = row
    assert len(GRID_VARIANTS) == len(FLASH_GRID)
    assert fa.variant(getattr(torch, dtype), sq, hq, hkv, dk, dv) == want


# every arch's bf16 prefill at 2048 tokens: a tensor-core variant (hubert's
# head dim 80 too); mamba2 has no attention layer (no heads, no dims)
ARCH_PREFILL = {
    "qwen2-vl-2b": "prefill_tc", "glm4-9b": "prefill_tc",
    "phi4-mini-3.8b": "prefill_tc", "minitron-4b": "prefill_tc",
    "gemma3-27b": "prefill_tc", "deepseek-v2-236b": "prefill_tc",
    "mixtral-8x7b": "prefill_tc", "hubert-xlarge": "prefill_tc",
    "mamba2-780m": "simt", "zamba2-1.2b": "prefill_tc",
}


@pytest.mark.parametrize("arch", sorted(ARCH_PREFILL))
def test_variant_of_every_arch_prefill(arch):
    from repro_torch.configs import ARCH_IDS, get_config

    assert sorted(ARCH_IDS) == sorted(ARCH_PREFILL)
    cfg = get_config(arch)
    if cfg.mla is not None:
        dk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        dv = cfg.mla.v_head_dim
    else:
        dk = dv = cfg.head_dim
    got = fa.variant(BF16, 2048, cfg.n_heads, cfg.n_kv_heads, dk, dv)
    assert got == ARCH_PREFILL[arch]


@pytest.mark.parametrize("b,hkv,skv,want", [
    (4, 2, 2080, 32),       # glm4-9b decode: min(ceil(264 / 8), 2080 // 64)
    (2, 2, 2080, 32),       # min(66, 32)
    (8, 8, 4096, 5),        # min(ceil(264 / 64), 64)
    (1, 1, 100, 1),         # one split of at least 64 keys
    (1, 1, 63, 1),          # fewer keys than a split: still one
    (300, 1, 8192, 1),      # more (b, kv head) pairs than blocks wanted
])
def test_decode_splits_from_the_shapes(b, hkv, skv, want):
    assert fa.decode_splits(b, hkv, skv) == want


@pytest.mark.parametrize("b,hkv,skv,rows,dv,want", [
    # glm4-9b decode: 4 x 2 x 32 splits x 16 rows = 4096 slots
    (4, 2, 2080, 16, 128, 2 * 4096 + 4096 * 128),
    # 3 slots: the (m, l) pairs padded from 6 to 8 floats (16 bytes)
    (1, 1, 64, 3, 64, 8 + 3 * 64),
])
def test_decode_scratch_size(b, hkv, skv, rows, dv, want):
    assert fa.decode_scratch_floats(b, hkv, skv, rows, dv) == want


def test_cpu_attention_leaves_the_counts_alone():
    """On CPU tensors ops.attention takes the plain version: no variant
    count moves."""
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 4, 64, generator=g)
    k = torch.randn(1, 4, 2, 64, generator=g)
    pos = torch.arange(4, dtype=torch.int32)[None]
    before = (fa.launches, dict(fa.variant_launches))
    ops.attention(q, k, k, q_positions=pos, kv_positions=pos)
    assert (fa.launches, fa.variant_launches) == before
    assert set(fa.variant_launches) == set(fa.VARIANTS)


def test_sass_compare_splits_functions_and_judges_each():
    """``tools/sass_compare.py`` (how a template edit is shown to leave the
    other instantiations' SASS as it was): cuobjdump's text split by entry
    function, each judged same, differs or one tree's."""
    path = Path(__file__).resolve().parents[1] / "tools" / "sass_compare.py"
    spec = importlib.util.spec_from_file_location("sass_compare", path)
    sass = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sass)

    dump = """
	code for sm_90a
		Function : _Z6kernelILi64EEvv
	.headerflags	@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
        /*0010*/                   EXIT ;                   /* 0x000000000000794d */
		Function : _Z6kernelILi80EEvv
        /*0000*/                   EXIT ;                   /* 0x000000000000794d */
		Function : _Z5otherv
        /*0000*/                   NOP ;                    /* 0x0000000000007918 */
"""
    mine = sass.functions(dump)
    assert sorted(mine) == ["_Z5otherv", "_Z6kernelILi64EEvv",
                            "_Z6kernelILi80EEvv"]
    assert len(mine["_Z6kernelILi64EEvv"]) == 3
    other = {"_Z6kernelILi64EEvv": mine["_Z6kernelILi64EEvv"],
             "_Z6kernelILi128EEvv": ["/*0000*/ EXIT ;"]}
    got = {r["function"]: (r["verdict"], r["instructions"])
           for r in sass.compare(mine, other, "kernel")}
    assert got == {"_Z6kernelILi64EEvv": ("same", 2),
                   "_Z6kernelILi80EEvv": ("only_this_tree", 1),
                   "_Z6kernelILi128EEvv": ("only_other_tree", 1)}
    changed = dict(other, _Z6kernelILi64EEvv=["/*0000*/ EXIT ;"])
    assert sass.compare(mine, changed, "ILi64")[0]["verdict"] == "differs"


def test_sass_compare_covers_every_tc_kernel():
    """``tools/sass_compare.py`` judges every ``__global__`` function of
    the tc headers (the prefill_tc forward and each backward kernel), so
    its plain command shows every instantiation an edit may touch."""
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "sass_compare", root / "tools" / "sass_compare.py")
    sass = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sass)
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    names = set()
    for header in ("flash_prefill_tc.cuh", "flash_backward_tc.cuh"):
        text = (csrc / header).read_text()
        names |= set(re.findall(r"__global__[^\n]*\n(\w+)\(", text))
    assert names == {"prefill_tc_kernel", "dkdv_tc_kernel", "dkdv_tc2_kernel",
                     "dq_tc_kernel", "reduce_tc_kernel"}
    for name in names:
        hits = [m for m in sass.MARKERS if m in f"_ZN5flash{name}ILi64E"]
        assert hits == [name], (name, hits)


# -- split-TF32: the simt kernels' arithmetic, on the CPU -----------------------

FLASH_TOL = 2e-5     # f32 output, atol and rtol (test_torch_cuda.py)
LSE_TOL = 1e-4       # the rows' log-sum-exp, absolute


def _bits(t: torch.Tensor) -> torch.Tensor:
    """fp32 bit patterns as non-negative int64."""
    return t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _normals(n: int, seed: int) -> torch.Tensor:
    """fp32 values of both signs over exponents 2^-100..2^100."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp2(rng.integers(-100, 100, n))
    return torch.from_numpy(x.astype(np.float32))


def test_tf32_split_parts_have_no_bit_below_the_tenth_mantissa_bit():
    x = torch.cat([_normals(4096, 0), torch.tensor(
        [0.0, -0.0, 1.0, -1.0, 3e38, -3e38, 1e-40, -1e-40])])
    big, small = ref.tf32_split(x)
    assert not bool((_bits(big) & 0x1FFF).any())
    assert not bool((_bits(small) & 0x1FFF).any())


@pytest.mark.parametrize("low,up", [(0x1000, True), (0x0FFF, False),
                                    (0x1001, True), (0x0000, False),
                                    (0x1FFF, True), (0x0001, False)])
def test_tf32_split_rounds_to_nearest_ties_away_from_zero(low, up):
    """The 13 bits below the TF32 mantissa at a tie (half an ulp), just
    under and just over it: big's magnitude rounds up at and above the
    tie, down below it, for either sign (cvt.rna's rule)."""
    rng = np.random.default_rng(low)
    sign = rng.integers(0, 2, 512).astype(np.int64) << 31
    head = (rng.integers(1, 254, 512).astype(np.int64) << 23) \
        | (rng.integers(0, 1 << 10, 512).astype(np.int64) << 13)
    bits = sign | head | low
    x = torch.from_numpy(np.where(bits >= 1 << 31, bits - (1 << 32), bits)
                         .astype(np.int32)).view(torch.float32)
    big, _ = ref.tf32_split(x)
    want = torch.from_numpy(sign | (head + (int(up) << 13)))
    assert torch.equal(_bits(big), want)


def test_tf32_split_parts_sum_to_the_value_within_2_to_the_minus_22():
    x = _normals(4096, 1)
    big, small = ref.tf32_split(x)
    err = ((big.double() + small.double()) - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    assert float((err / x.double().abs()).max()) > 0   # small is rounded


def test_tf32_split_of_a_bf16_value_has_no_small_part():
    x = _normals(4096, 2).to(torch.bfloat16).float()
    big, small = ref.tf32_split(x)
    assert torch.equal(big, x)
    assert not bool(small.any())


# (B, Sq, Skv, Hq, Hkv, Dk, Dv, causal, window, softcap): the reference's
# f32 grid (chip_smoke.py's kernel_flash grid, its f32 rows), then
# deepseek-v2's MLA dims (Dk 192, Dv 128) at a small depth, with a window
# and a softcap
X3_GRID = [
    (2, 128, 128, 4, 2, 32, 32, True, None, 0.0),
    (1, 100, 100, 4, 4, 16, 16, True, None, 0.0),
    (2, 128, 128, 4, 2, 32, 32, True, 40, 0.0),
    (2, 64, 192, 4, 2, 32, 32, True, None, 0.0),
    (2, 128, 128, 4, 4, 32, 32, False, None, 0.0),
    (1, 256, 256, 2, 2, 192, 128, True, None, 0.0),
    (1, 72, 72, 2, 1, 24, 24, True, 16, 0.0),
    (2, 96, 96, 4, 4, 192, 128, True, None, 0.0),
    (1, 96, 160, 4, 4, 192, 128, True, 48, 30.0),
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,dk,dv,causal,window,cap", X3_GRID)
def test_sdpa_x3_ref_meets_the_f32_limits(b, sq, skv, hq, hkv, dk, dv,
                                          causal, window, cap):
    """Split-TF32 products against the plain fp32 version and the
    reference's JAX function: the output within FLASH_TOL, the rows'
    log-sum-exp within LSE_TOL of the plain one."""
    rng = np.random.default_rng(sq * skv + dk + dv)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, sq, hq, dk), (b, skv, hkv, dk),
                             (b, skv, hkv, dv)))
    qp = np.broadcast_to(np.arange(skv - sq, skv, dtype=np.int32),
                         (b, sq)).copy()
    kp = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv)).copy()
    kw = dict(causal=causal, sliding_window=window, logit_softcap=cap)
    t = torch.from_numpy
    pos = dict(q_positions=t(qp), kv_positions=t(kp))
    got, got_lse = ref.sdpa_x3_ref(t(q), t(k), t(v), return_lse=True, **pos,
                                   **kw)
    plain, plain_lse = ref.sdpa_ref(t(q), t(k), t(v), return_lse=True, **pos,
                                    **kw)
    want = np.array(jref.sdpa_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qp), kv_positions=jnp.asarray(kp), **kw))
    assert got.dtype == torch.float32 and got.shape == (b, sq, hq, dv)
    torch.testing.assert_close(got, plain, atol=FLASH_TOL, rtol=FLASH_TOL)
    torch.testing.assert_close(got, t(want), atol=FLASH_TOL, rtol=FLASH_TOL)
    assert float((got_lse - plain_lse).abs().max()) <= LSE_TOL
    assert not torch.equal(got, plain)     # the split is not a no-op
