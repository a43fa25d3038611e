"""Plain attention: f32 logits and softmax, the probabilities rounded to
the activations' type before the product with v (the JAX package's
``_seq_attn_reference`` and ``_nhwc_reference``).

``ATTENTION_CALLS``, when a list, receives one record per call, which
the benchmark's roofline counts read: (kind, batch, heads, queries, keys,
head dim, bias elements)."""
from __future__ import annotations

import math

import torch

ATTENTION_CALLS = None


def _note(*record) -> None:
    if ATTENTION_CALLS is not None:
        ATTENTION_CALLS.append(record)


def seq_attention(qkv: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    """qkv (B, S, 3C) packed [q | k | v] -> (B, S, C) head-major."""
    B, S, c3 = qkv.shape
    C = c3 // 3
    d = C // heads
    _note("seq", B, heads, S, S, d, 0)
    q, k, v = torch.split(qkv, C, dim=-1)

    def split(t):  # (B, S, C) -> (B, heads, S, d)
        return t.reshape(B, S, heads, d).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    logits = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v)
    return out.transpose(1, 2).reshape(B, S, C)


def window_attention_nhwc(qkv: torch.Tensor, bias: torch.Tensor,
                          scale: float, heads: int) -> torch.Tensor:
    """qkv (B, H, W, 3C), bias (nB, s, s) f32 -> (B, H, W, C); window
    (i, j) takes ``bias[(i * nww + j) % nB]``."""
    B, H, W, c3 = qkv.shape
    C = c3 // 3
    d = C // heads
    s = bias.shape[-1]
    ws = int(round(math.sqrt(s)))
    if ws * ws != s:
        raise ValueError(f"bias rows {s} are not a square window")
    nwh, nww = H // ws, W // ws
    nW = nwh * nww
    _note("window", B * nW, heads, s, s, d, bias.numel())
    t = qkv.reshape(B, nwh, ws, nww, ws, 3, heads, d)
    t = t.permute(5, 0, 6, 1, 3, 2, 4, 7).reshape(3, B, heads, nW, s, d)
    q, k, v = t[0], t[1], t[2]
    win = torch.arange(nW, device=bias.device) % bias.shape[0]
    dots = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    dots = dots + bias.float()[win]
    probs = torch.softmax(dots, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v)                      # (B, heads, nW, s, d)
    out = out.reshape(B, heads, nwh, nww, ws, ws, d)
    return out.permute(0, 2, 4, 3, 5, 1, 6).reshape(B, H, W, C)
