"""The roofline's and the MFU's counts against hand counts at one small
shape: one pre-LN transformer block of width 64, 4 heads, 10 tokens."""
import pytest
import torch

from portbench.harness import peaks
from portbench.harness.counts import count
from portbench.reference.layers import ResidualAttentionBlock


def test_block_flops_and_attention_record():
    B, S, D, H = 2, 10, 64, 4
    with torch.device("meta"):
        blk = ResidualAttentionBlock(D, H).requires_grad_(False)
        x = torch.zeros(B, S, D)
    flops, attn = count(lambda: blk(x))
    # qkv, out, two MLP matrices (2 flops a multiply-add), QK^T and PV
    hand = 2 * B * S * (D * 3 * D + D * D + D * 4 * D + 4 * D * D) + 4 * B * H * S * S * (D // H)
    assert flops == hand
    assert attn == [("seq", B, H, S, S, D // H, 0)]


def test_attention_least_time_by_hand():
    rec = [("seq", 2, 4, 10, 10, 16, 0), ("window", 8, 12, 256, 256, 64, 65536)]
    f0, b0 = 4.0 * 2 * 4 * 10 * 10 * 16, 2 * (2 * 4 * 16 * 30 + 2 * 4 * 10 * 16)
    f1 = 4.0 * 8 * 12 * 256 * 256 * 64
    b1 = 2 * (8 * 12 * 64 * 768 + 8 * 12 * 256 * 64) + 4 * 65536
    hand = max(f0 / 989e12, b0 / 3.35e12) + max(f1 / 989e12, b1 / 3.35e12)
    assert peaks.attention_least_s(rec, "bfloat16") == pytest.approx(hand, rel=1e-12)


def test_trace_reduction_by_hand():
    """Busy time, range attribution and idle gaps of a synthetic trace."""
    from portbench.harness.trace import Trace
    ev = [
        {"cat": "user_annotation", "name": "portbench.window", "ts": 0, "dur": 100, "tid": 1},
        {"cat": "user_annotation", "name": "decode_device", "ts": 10, "dur": 20, "tid": 1},
        {"cat": "cuda_runtime", "name": "launch", "ts": 12, "dur": 1, "tid": 1, "args": {"correlation": 7}},
        {"cat": "cuda_runtime", "name": "launch", "ts": 50, "dur": 1, "tid": 1, "args": {"correlation": 8}},
        {"cat": "kernel", "name": "seq_attention_kernel<float, 2>", "ts": 20, "dur": 30, "args": {"correlation": 7}},
        {"cat": "kernel", "name": "gemm", "ts": 60, "dur": 10, "args": {"correlation": 8}},
    ]
    t = Trace(ev)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)
    assert t.range_device_s({"decode_device"}) == pytest.approx(30e-6)
    assert t.kernel_s(lambda n: "attention" in n) == pytest.approx(30e-6)
    gaps = t.idle_gaps()
    assert [g[1] for g in gaps] == pytest.approx([30e-6, 20e-6, 10e-6])
