"""The flash kernel's routing, pinned on the CPU.

``flash_attention.variant`` is the Python twin of the C launcher's choice
among ``prefill_tc``, ``decode_split`` and ``simt`` (the launcher reports
its choice and the wrapper checks the two agree on the card;
``tests/test_torch_cuda.py`` holds the C side to it).  These tests need no
card: they pin the choice for glm4-9b's shapes, for every row of the card
tests' ``FLASH_GRID`` and at the edges of each variant.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
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
