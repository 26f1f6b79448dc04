"""mfu: the model's FLOPs that the measured window completed (the family's
``forward_flops``: every weight matrix a token passes, the head, causal
attention's visible pairs, the SSD's chunk products; a training step 3x
its forward) over the window's wall time, as a share of the card's bf16
peak (``arith``)."""
import arith


def read(w):
    if w["wall_s"] <= 0 or w["flops"] <= 0:
        return None
    return 100.0 * w["flops"] / w["wall_s"] / arith.PEAK_BF16_FLOPS
