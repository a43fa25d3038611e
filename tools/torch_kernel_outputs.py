#!/usr/bin/env python3
"""Outputs of the port's attention kernels on seeded inputs, saved for a
bit-for-bit comparison of two trees on one CUDA card.

    python3 tools/torch_kernel_outputs.py save <tree> <out.pt>
    python3 tools/torch_kernel_outputs.py compare <a.pt> <b.pt>

``save`` imports ``sic_tpu_torch`` from ``<tree>`` (a checkout of the
repository), builds its kernels, and runs each f32 and bf16 entry of
kernels 1, 2, 5 and 6 at the shapes of ``chip_smoke.py``'s kernels phase
(the flagship's), each input drawn from its own seeded generator.
``compare`` prints, for every entry, whether the two files hold the same
bits and the largest difference, as one JSON line; it exits 1 if an f32
entry differs (the f32 entries are not to change when a bf16 one does).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


def _inputs(torch, shape, seed, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, device="cuda", generator=g).to(dtype)


def save(tree: str, out: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from sic_tpu_torch import ops
    from sic_tpu_torch.models import configure_numerics
    from sic_tpu_torch.models.swin import _full_shift_mask
    configure_numerics()
    res = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for name, (B, S, C, heads) in {"trunk": (4, 289, 1024, 16),
                                       "cross": (4, 545, 768, 12),
                                       "clip": (1, 50, 768, 12),
                                       "maskgit": (4, 33, 768, 16)}.items():
            qkv = _inputs(torch, (B, S, 3 * C), S, dtype)
            res[f"seq_attention_{name}_{tag}"] = ops.seq_attention(
                qkv, (C // heads) ** -0.5, heads)
        for C, heads in ((768, 12), (1024, 16)):
            qkv = _inputs(torch, (2, 32, 32, 3 * C), C, dtype)
            g = _inputs(torch, (2, 32, 32, C), C + 1, dtype)
            rel = _inputs(torch, (1, 256, 256), C + 2, torch.float32)
            shifted = (rel + torch.from_numpy(_full_shift_mask(2, 2, 16)).cuda()).contiguous()
            for nB, bias in ((1, rel), (4, shifted)):
                key = f"c{C}_nb{nB}_{tag}"
                res[f"window_attention_{key}"] = ops.window_attention_nhwc(
                    qkv, bias, 0.125, heads)
                dqkv, dbias = ops.window_attention_nhwc_bwd(qkv, bias, g, 0.125, heads)
                res[f"window_attention_bwd_dqkv_{key}"] = dqkv
                res[f"window_attention_bwd_dbias_{key}"] = dbias
        q, k, v = (_inputs(torch, (48, 256, 64), i, dtype) for i in (3, 4, 5))
        bias = (_inputs(torch, (4, 256, 256), 6, torch.float32)
                + torch.from_numpy(_full_shift_mask(2, 2, 16)).cuda()).contiguous()
        res[f"window_attention_gsd_{tag}"] = ops.window_attention(q, k, v, bias, 0.125)
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in res.items()}, out)


def compare(a: str, b: str) -> int:
    import torch
    x, y = torch.load(a), torch.load(b)
    rows = {k: {"bit_equal": torch.equal(x[k], y[k]),
                "max_abs_diff": (x[k].double() - y[k].double()).abs().max().item()}
            for k in sorted(x)}
    f32_equal = all(r["bit_equal"] for k, r in rows.items() if k.endswith("_f32"))
    print(json.dumps({"f32_bit_equal": f32_equal, "entries": rows}))
    return 0 if f32_equal else 1


if __name__ == "__main__":
    if sys.argv[1] == "save":
        save(sys.argv[2], sys.argv[3])
    else:
        sys.exit(compare(sys.argv[2], sys.argv[3]))
