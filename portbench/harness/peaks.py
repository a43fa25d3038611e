"""Published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit):
the yardstick of every roofline and MFU share.  f32 work is held to
TF32's tensor-core rate, since the port's f32 attention already runs split
TF32 there; a share against the f32 cores' 67 TFLOP/s could pass 100%."""
from __future__ import annotations

FLOPS = {"bfloat16": 989e12, "float32": 495e12}
HBM_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def attention_least_s(records, dtype: str) -> float:
    """The least time the attention calls ``records`` need on the card:
    for each, the larger of its FLOPs (QK^T and PV, 4 B H Sq Sk d) over
    the peak and its bytes (q, k and v read once, the output written once,
    an f32 bias read once) over HBM's rate."""
    peak, elem = FLOPS[dtype], ELEMENT_BYTES[dtype]
    total = 0.0
    for _kind, b, h, sq, sk, d, bias in records:
        flops = 4.0 * b * h * sq * sk * d
        nbytes = elem * (b * h * d * (sq + 2 * sk) + b * h * sq * d) + 4 * bias
        total += max(flops / peak, nbytes / HBM_BYTES_PER_S)
    return total
