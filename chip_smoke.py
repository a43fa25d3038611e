#!/usr/bin/env python3
"""Chip check of the PyTorch port's encode and decode paths on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing one JSON line with the card's name and power limit:

1. build    - the four CUDA kernels (one nvcc per source, in parallel) and
              the native rANS coder, from the sources in the checkout;
2. kernels  - each kernel against its plain PyTorch version on the card at
              the flagship's shapes (rANS encode also against the native
              encoder, and through one forced buffer overflow), with
              CUDA-event times of the kernel, the plain version and, for
              attention, one scaled_dot_product_attention call as a
              yardstick;
3. golden   - the JAX-encoded tests/fixtures/golden stream through the CLI
              (host coder) and through the rANS decode kernel, against the
              committed pixels; then golden_input() encoded on the card by
              the host coder and by the encode kernel, byte-equal, decoding
              back bit for bit, and compared (not asserted) with
              golden.c2df;
4. encode   - seeded flagship model (TiTok-L, fp32) and seeded CLIP
              ViT-B/32 on real images (artifacts_r05/heldout: eight 256x256,
              a 512x512 mosaic, a 256x768 strip): the compress CLI over the
              ten, encode_only / encode_only_batched with the encode kernel
              and with the host coder (byte-equal), every stream decoding
              back to the encoder's y_hat bit for bit, times and a profile;
5. flagship - decode_only / decode_only_batched / the decompress CLI on
              streams from phase 4 (one 512x512, one 256x768, four
              256x256), every h_hat equal to the encoder's y_hat;
6. cpu      - the first 256x256 request decoded again on the CPU (plain
              versions): CDF-index planes and pixels against the card's;
              and one 256x256 image encoded on the CPU, its differences
              from the card's encode reported.

Each path's launch counts are set to 0 just before it is driven (phase 4
for the encode, phase 5 for the decode) and read just after; every kernel
of the path must have launched.  Then a ``{"kernels": [...]}`` line, the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``.  Exits
non-zero, with no result line, without a CUDA device, outside the
repository, or if any phase fails.  Work files go to ``WORK`` below.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "chiprun_out" / "chip_smoke"
GOLDEN = ROOT / "tests" / "fixtures" / "golden"
HELDOUT = ROOT / "artifacts_r05" / "heldout"

F32_TFLOPS = 67e12      # H100 SXM f32 outside the tensor cores
HBM_BYTES_S = 3.35e12   # H100 SXM HBM3
ATTN_TOL = 1e-4         # kernel vs plain, fp32: only the summation order differs
CPU_PIXEL_TOL = 1e-3    # card vs CPU decode of the flagship, [-1, 1] floats
SEED = 0


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.card = _card_line()
        self.failed = []
        self.kernels = {}
        self.counts = {}      # path -> launch counts of its main-path run
        self.requests = {}    # stem -> decode_only kwargs + the encoder's y_hat

    def phase(self, name, fn):
        t0 = time.perf_counter()
        rec = {"phase": name, "card": self.card}
        try:
            rec.update(fn() or {})
            rec["ok"] = True
        except Exception as e:  # report the phase, go on with the next
            rec["ok"] = False
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-3000:]
            self.failed.append(name)
        rec["seconds"] = round(time.perf_counter() - t0, 3)
        print(json.dumps(rec), flush=True)

    # -- helpers --------------------------------------------------------------
    def time_ms(self, fn, iters=20, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    @staticmethod
    def bound(flops, nbytes):
        t_ops, t_bytes = flops / F32_TFLOPS, nbytes / HBM_BYTES_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    # -- phase 1 ----------------------------------------------------------------
    def build(self):
        from sic_tpu_torch.cpp.build import load_library
        from sic_tpu_torch.ops import cuda_build
        native = {}

        def _native():
            try:
                load_library()
            except Exception as e:  # reported below
                native["error"] = e

        th = threading.Thread(target=_native)
        t0 = time.perf_counter()
        th.start()
        reports = cuda_build.build()
        th.join()
        if "error" in native:
            raise native["error"]
        regs = {n: [ln.strip() for ln in r.splitlines()
                    if "registers" in ln or "spill" in ln]
                for n, r in reports.items()}
        for n in cuda_build.KERNELS:
            cuda_build.load(n)
        return {"built": sorted(reports), "build_s": round(time.perf_counter() - t0, 3),
                "ptxas": regs}

    # -- phase 2 ----------------------------------------------------------------
    def kernel_checks(self):
        torch = self.torch
        import torch.nn.functional as F

        from sic_tpu_torch import ops
        from sic_tpu_torch.models.swin import _full_shift_mask
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(SEED)
        out = {}

        # kernel 1: trunk (4 tiles of a 512x512 image), cross blocks, and
        # the CLIP image tower (one image, 1 + 7*7 tokens)
        for tag, (B, S, C, heads) in {"trunk": (4, 289, 1024, 16),
                                      "cross": (4, 545, 768, 12),
                                      "clip": (1, 50, 768, 12)}.items():
            qkv = torch.randn((B, S, 3 * C), device=dev, generator=g)
            scale = 64 ** -0.5
            k_out = ops.seq_attention(qkv, scale, heads)
            p_out = ops.seq_attention_plain(qkv, scale, heads)
            err = (k_out - p_out).abs().max().item()
            d = C // heads
            q, k, v = (t.view(B, S, heads, d).transpose(1, 2)
                       for t in qkv.split(C, dim=-1))
            lib = F.scaled_dot_product_attention(q, k, v, scale=scale)
            lib_err = (lib.transpose(1, 2).reshape(B, S, C) - p_out).abs().max().item()
            rec = {
                "shape": [B, S, 3 * C], "heads": heads, "max_abs_err": err,
                "library_max_abs_err": lib_err,
                "ms": self.time_ms(lambda: ops.seq_attention(qkv, scale, heads)),
                "plain_ms": self.time_ms(lambda: ops.seq_attention_plain(qkv, scale, heads)),
                "library_ms": self.time_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
            }
            rec["bound_ms"], rec["bound_by"] = self.bound(
                4 * B * heads * S * S * d, B * S * 4 * C * 4)
            if not err <= ATTN_TOL:
                raise AssertionError(f"seq_attention {tag}: max abs err {err}")
            out[f"seq_attention_{tag}"] = rec
        self.kernels["seq_attention"] = out["seq_attention_trunk"]

        # kernel 2: the 512x512 feature map (32x32, 2x2 windows of 16x16),
        # widths 768 and 1024, shared bias (nB = 1) and shifted (nB = nW)
        ws, s = 16, 256
        for C, heads in ((768, 12), (1024, 16)):
            qkv = torch.randn((1, 32, 32, 3 * C), device=dev, generator=g)
            rel = torch.randn((1, s, s), device=dev, generator=g)
            for nB in (1, 4):
                bias = rel if nB == 1 else (rel + torch.from_numpy(
                    _full_shift_mask(2, 2, ws)).to(dev)).contiguous()
                scale = 64 ** -0.5
                k_out = ops.window_attention_nhwc(qkv, bias, scale, heads)
                p_out = ops.window_attention_nhwc_plain(qkv, bias, scale, heads)
                if not torch.isfinite(k_out).all():
                    raise AssertionError(f"window_attention C={C} nB={nB}: non-finite")
                err = (k_out - p_out).abs().max().item()
                # SDPA yardstick on pre-windowed (B*nW, heads, s, d) tensors;
                # the relayout into that form is not timed
                d = C // heads
                t = qkv.reshape(1, 2, ws, 2, ws, 3, heads, d).permute(
                    5, 0, 1, 3, 6, 2, 4, 7).reshape(3, 4, heads, s, d).contiguous()
                mask = bias.expand(4, s, s)[:, None]
                rec = {
                    "shape": [1, 32, 32, 3 * C], "heads": heads, "nB": nB,
                    "max_abs_err": err,
                    "ms": self.time_ms(lambda: ops.window_attention_nhwc(qkv, bias, scale, heads)),
                    "plain_ms": self.time_ms(
                        lambda: ops.window_attention_nhwc_plain(qkv, bias, scale, heads)),
                    "library_ms": self.time_ms(lambda: F.scaled_dot_product_attention(
                        t[0], t[1], t[2], attn_mask=mask, scale=scale)),
                }
                rec["bound_ms"], rec["bound_by"] = self.bound(
                    4 * 4 * heads * s * s * d, 32 * 32 * 4 * C * 4 + nB * s * s * 4)
                if not err <= ATTN_TOL:
                    raise AssertionError(f"window_attention C={C} nB={nB}: err {err}")
                out[f"window_attention_c{C}_nb{nB}"] = rec
        self.kernels["window_attention_nhwc"] = out["window_attention_c768_nb4"]

        out["rans_decode"] = self.kernels["rans_decode_plane"] = self._rans_check()
        enc = {f"{S}x{npos}": self._rans_encode_check(S, npos)
               for S, npos in ((4, 1024), (32, 256))}
        # the same plane with no escapes: how much of the time is the
        # escape path, whose loops diverge across a warp's substreams; and
        # one position a plane: the launch and the CDF-table fill alone
        enc["4x1024_no_escapes"] = self._rans_encode_check(4, 1024, escape_rate=0.0)
        enc["4x1"] = self._rans_encode_check(4, 1, escape_rate=0.0)
        out["rans_encode"] = enc
        out["rans_encode_overflow"] = self._rans_encode_overflow()
        self.kernels["rans_encode_plane"] = enc["4x1024"]
        return out

    def _rans_check(self):
        """Four 512x512 planes (16x16 latent, 64 channels -> 4096 positions
        a plane) written by the native encoder into 4 substreams, escapes
        included, decoded by the kernel with its state carried across the
        planes."""
        import numpy as np
        torch = self.torch
        from sic_tpu_torch import ops
        from sic_tpu_torch.entropy import EntropyCoder, build_gaussian_tables
        from sic_tpu_torch.ops.rans_decode import words_tensor
        t = build_gaussian_tables("gaussian")
        rng = np.random.default_rng(SEED)
        n, nparts = 4096, 4
        planes = []
        for _ in range(4):
            idx = rng.integers(0, t.levels, n).astype(np.int16)
            skip = rng.random(n) < 0.2
            idx[skip] = -1
            sym = rng.integers(-6, 7, n).astype(np.int16)
            esc = rng.random(n) < 0.05
            sym[esc] = rng.integers(-4000, 4000, int(esc.sum())).astype(np.int16)
            sym[skip] = 0
            planes.append((sym, idx))
        coder = EntropyCoder(nparts)
        grp = coder.add_cdf(t.quantized_cdf, t.cdf_length, t.offset)
        coder.reset()
        for sym, idx in planes:
            coder.encode_with_indexes(sym, idx, grp)
        coder.flush()
        stream = coder.get_encoded_stream()
        coder.set_stream(stream)
        host = [coder.decode_stream(idx, grp).astype(np.int32) for _, idx in planes]

        dev = torch.device("cuda")
        parts = ops.split_substreams(stream)
        words_np, lens_np, state_np = ops.pack_substreams(parts)
        S, npos = nparts, n // nparts
        words = words_tensor(words_np, dev)
        lens = torch.from_numpy(lens_np.reshape(-1)).to(dev)
        tables = [torch.from_numpy(a.astype(np.int32)).to(dev)
                  for a in (t.quantized_cdf, t.cdf_length, t.offset)]
        rows = [torch.from_numpy(idx.astype(np.int32).reshape(nparts, npos)).to(dev)
                for _sym, idx in planes]
        st0 = torch.from_numpy(state_np).to(dev)

        def run(fn):
            st, syms = st0, []
            for r in rows:
                sym, st = fn(r, words, lens, st, *tables)
                syms.append(sym)
            return syms, st

        k_syms, k_st = run(ops.rans_decode_plane)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_syms, p_st = run(ops.rans_decode_plane_plain)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 / 4
        mism = sum(int((k.reshape(-1).cpu().numpy() != h).sum())
                   for k, h in zip(k_syms, host))
        state_eq = bool(torch.equal(k_st, p_st)) and all(
            torch.equal(a, b) for a, b in zip(k_syms, p_syms))
        # a fully decoded stream ends where its encoder started: x = L and
        # every byte consumed
        final = k_st.cpu().numpy()
        end_ok = bool((final[:, 0] == 1 << 23).all()
                      and (final[:, 1] == lens_np[:, 0]).all())
        ms = self.time_ms(lambda: run(ops.rans_decode_plane), iters=10) / 4
        # one plane's bytes, as ``ms`` is one plane's time: indexes in,
        # symbols out, the state in and out, the CDF table, and a quarter
        # of the stream bytes the four planes consumed
        consumed = int((final[:, 1] - state_np[:, 1]).sum())
        nbytes = (2 * S * npos * 4 + consumed / 4 + 4 * S * 8
                  + t.quantized_cdf.size * 4)
        bound_ms, bound_by = self.bound(0, nbytes)
        if mism or not state_eq or not end_ok:
            raise AssertionError(f"rans_decode: {mism} symbol mismatches, "
                                 f"state equal {state_eq}, end state ok {end_ok}")
        return {"substreams": nparts, "npos": npos,
                "stream_bytes": len(stream), "stream_bytes_consumed": consumed,
                "escapes": int(sum((np.abs(s) > 50).sum() for s, _ in planes)),
                "max_abs_err": 0, "symbol_mismatches": mism,
                "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by}

    def _rans_encode_check(self, S, npos, escape_rate=0.05):
        """Four planes of S substreams x npos positions (4 x 1024: one
        512x512 request; 32 x 256: eight 256x256), skips and escapes up
        to the +-30000 clamp, encoded last plane first by the kernel, by
        its plain version and by the native encoder: bytes must agree."""
        import numpy as np
        torch = self.torch
        from sic_tpu_torch import ops
        from sic_tpu_torch.entropy import EntropyCoder, build_gaussian_tables
        from sic_tpu_torch.models.bottleneck import worst_case_bytes
        from sic_tpu_torch.ops import rans_encode as renc
        t = build_gaussian_tables("gaussian")
        rng = np.random.default_rng(SEED + S)
        planes, n_esc = [], 0
        for _ in range(4):
            idx = rng.integers(0, t.levels, (S, npos)).astype(np.int16)
            idx[rng.random((S, npos)) < 0.2] = -1
            live = idx >= 0
            off = t.offset[np.maximum(idx, 0)]
            top = t.cdf_length[np.maximum(idx, 0)] - 2     # the escape slot
            if escape_rate:
                sym = rng.integers(-6, 7, (S, npos)).astype(np.int16)
                esc = rng.random((S, npos)) < escape_rate
                sym[esc] = rng.integers(-30000, 30001, int(esc.sum())).astype(np.int16)
            else:   # every symbol inside its row's coded range
                sym = (off + (rng.random((S, npos)) * top).astype(np.int64)).astype(np.int16)
            sym[~live] = 0
            value = sym.astype(np.int64) - off
            n_esc += int((live & ((value < 0) | (value >= top))).sum())
            planes.append((sym, idx))
        # the native coder, one substream each (its per-part split of a
        # plane is contiguous, so substream s codes row s of every plane)
        native = []
        for s_ in range(S):
            coder = EntropyCoder(1)
            g = coder.add_cdf(t.quantized_cdf, t.cdf_length, t.offset)
            coder.reset()
            for sym, idx in planes:
                coder.encode_with_indexes(sym[s_], idx[s_], g)
            coder.flush()
            native.append(coder.get_encoded_stream()[1:])   # drop the flag byte

        dev = torch.device("cuda")
        tables = [torch.from_numpy(a.astype(np.int32)).to(dev)
                  for a in (t.quantized_cdf, t.cdf_length, t.offset)]
        rows = [[torch.from_numpy(a.astype(np.int32)).to(dev) for a in p]
                for p in planes]
        nwords = -(-worst_case_bytes(4 * npos) // 4)
        words = torch.zeros((S, nwords), dtype=torch.int32, device=dev)
        st0 = renc.initial_state(S, dev)

        def run(fn):
            st = st0
            for sym, idx in reversed(rows):
                _, st = fn(sym, idx, words, st, *tables)
            return st

        results = {}
        for name, fn in (("kernel", ops.rans_encode_plane),
                         ("plain", ops.rans_encode_plane_plain)):
            words.zero_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = run(fn)
            torch.cuda.synchronize()
            results[name] = (renc.finalize_streams(words.cpu().numpy(),
                                                   st.cpu().numpy(), S),
                             (time.perf_counter() - t0) * 1e3 / 4, st)
        k_parts, _, k_st = results["kernel"]
        p_parts, plain_ms, p_st = results["plain"]
        mism = sum(a != b for a, b in zip(k_parts, native)) + \
            sum(a != b for a, b in zip(k_parts, p_parts))
        ms = self.time_ms(lambda: run(ops.rans_encode_plane), iters=10) / 4
        # one plane's bytes, as ``ms`` is one plane's time: symbols and
        # indexes in, the state in and out, the CDF table, and a quarter of
        # the bytes the four planes emitted
        emitted = int(k_st[:, 1].sum())
        nbytes = (2 * S * npos * 4 + 2 * S * 4 * 8 + emitted / 4
                  + (t.quantized_cdf.size + 2 * t.levels) * 4)
        bound_ms, bound_by = self.bound(0, nbytes)
        if mism or not torch.equal(k_st, p_st):
            raise AssertionError(f"rans_encode {S}x{npos}: {mism} substreams "
                                 f"differ; states equal {torch.equal(k_st, p_st)}")
        return {"substreams": S, "npos": npos, "bytes_emitted": emitted,
                "escape_rate": escape_rate, "escaped_positions": n_esc,
                "max_abs_err": 0, "byte_mismatches": mism,
                "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by}

    def _rans_encode_overflow(self):
        """The bottleneck's device encode from a buffer of 4 words a
        substream: it must overflow, double on the card until the streams
        fit, and then equal the host coder's bytes."""
        torch = self.torch
        from sic_tpu_torch import ops
        from sic_tpu_torch.models import bottleneck
        from sic_tpu_torch.models.bottleneck import (BottleneckCoder,
                                                     CompressiveBottleneck)
        from sic_tpu_torch.weights import init_seeded
        dev = torch.device("cuda")
        with torch.device(dev):
            m = CompressiveBottleneck(768, 64)
        init_seeded(m, SEED)
        coder = BottleneckCoder(m.eval().requires_grad_(False), stream_part=4)
        g = torch.Generator(device=dev).manual_seed(SEED + 2)
        y = torch.randn((2, 16, 16, 768), device=dev, generator=g)
        packed, y_hat = coder.compress_plan(y)
        host = coder.encode_packed_many(packed)
        before = ops.launch_counts()["rans_encode_plane"]
        first = bottleneck.encode_buffer_words
        bottleneck.encode_buffer_words = lambda npos: 4
        try:
            streams, y_hat_dev = coder.compress_device(y)
        finally:
            bottleneck.encode_buffer_words = first
        launches = ops.launch_counts()["rans_encode_plane"] - before
        rec = {"attempts": launches // 4, "streams_equal": streams == host,
               "y_hat_equal": bool(torch.equal(y_hat, y_hat_dev)),
               "stream_bytes": [len(s_) for s_ in streams]}
        if not (rec["streams_equal"] and rec["y_hat_equal"] and launches > 4):
            raise AssertionError(f"rans_encode overflow retry: {rec}")
        return rec

    # -- phase 3 ----------------------------------------------------------------
    def golden(self):
        import numpy as np
        torch = self.torch
        from PIL import Image

        from sic_tpu_torch.cli._common import load_runtime
        from sic_tpu_torch.cli.decompress import main as decompress_main
        from sic_tpu_torch.config import tiny_spec
        from sic_tpu_torch.container import sanitize_enc_result_types, unpack_c2df
        expected = np.load(GOLDEN / "expected_u8.npz")["u8"].astype(np.int32)

        def bound(u8):
            diff = np.abs(u8.astype(np.int32) - expected)
            return int(diff.max()), float((diff != 0).mean())

        src, dst = WORK / "golden_in", WORK / "golden_out"
        src.mkdir(parents=True, exist_ok=True)
        (src / "golden.c2df").write_bytes((GOLDEN / "golden.c2df").read_bytes())
        decompress_main(["--dataset_dir", str(src), "--save_dir", str(dst),
                         "--spec", "tiny", "--ckpt_path", str(GOLDEN / "params.npz"),
                         "--device", "cuda"])
        cli_max, cli_frac = bound(np.asarray(Image.open(dst / "golden.png")))

        rt = load_runtime(str(GOLDEN / "params.npz"), tiny_spec(), device="cuda")
        enc, header = unpack_c2df(GOLDEN / "golden.c2df")
        enc = sanitize_enc_result_types(enc)
        kw = dict(z_coder=header["z_coder"], coding_batch=header["coding_batch"],
                  output="u8")
        host, devp = {}, {}
        x_host = rt.decode_only(**enc, probe=host, **kw)
        rt.device_entropy = "device"
        x_dev = rt.decode_only(**enc, probe=devp, **kw)
        rt.close()
        planes_equal = all(torch.equal(a, b) for a, b in
                           zip(host["symbol_planes"], devp["symbol_planes"]))
        dev_max, dev_frac = bound(x_dev[0].cpu().numpy())
        rec = {"paths": [host["h_path"], devp["h_path"]],
               "symbol_planes_equal": planes_equal,
               "h_hat_equal": bool(torch.equal(host["h_hat"], devp["h_hat"])),
               "cli_max_diff": cli_max, "cli_changed_frac": cli_frac,
               "kernel_max_diff": dev_max, "kernel_changed_frac": dev_frac,
               "host_vs_kernel_pixels_equal": bool(torch.equal(x_host, x_dev))}
        ok = (planes_equal and rec["h_hat_equal"] and devp["h_path"] == "device"
              and cli_max <= 1 and cli_frac < 1e-3 and dev_max <= 1
              and dev_frac < 1e-3)
        if not ok:
            raise AssertionError(f"golden decode outside its bound: {rec}")
        rec["encode"] = self._golden_encode(devp)
        return rec

    def _golden_encode(self, golden_probe):
        """golden_input() under the golden params, encoded on the card with
        stream_part 1 by the host coder and by the encode kernel."""
        torch = self.torch
        sys.path.insert(0, str(ROOT / "tests"))
        from fixtures.golden.generate import golden_input

        from sic_tpu_torch.cli._common import load_runtime
        from sic_tpu_torch.config import tiny_spec
        from sic_tpu_torch.container import pack_c2df, unpack_c2df
        rt = load_runtime(str(GOLDEN / "params.npz"), tiny_spec(), device="cuda",
                          stream_part=1)
        encs, probes = {}, {}
        for path in ("host", "device"):
            rt.device_entropy = path
            probes[path] = {}
            encs[path] = rt.encode_only(golden_input()[None], probe=probes[path])
        dec = {}
        rt.decode_only(**encs["device"], coding_batch=8, probe=dec)
        header = {"version": 2, "image_hw": [256, 256], "padding": [0, 0, 0, 0],
                  "z_coder": "rans", "coding_batch": 8}
        wire = pack_c2df(encs["device"], header)
        z_card = rt._decode_z(encs["device"]["z_bit_stream"], 8, "rans")
        genc, _ = unpack_c2df(GOLDEN / "golden.c2df")
        z_gold = rt._decode_z(genc["z_bit_stream"], 8, "rans")
        rt.close()
        rec = {"paths": [probes["host"]["h_path"], probes["device"]["h_path"]],
               "host_vs_kernel_bytes_equal":
                   encs["host"]["h_bit_stream"] == encs["device"]["h_bit_stream"],
               "h_hat_equal_y_hat": bool(torch.equal(dec["h_hat"],
                                                     probes["device"]["y_hat"])),
               "equals_golden_c2df": wire == (GOLDEN / "golden.c2df").read_bytes(),
               "z_index_diffs_vs_golden": int((z_card != z_gold).sum()),
               "symbol_diffs_vs_golden": int(sum(
                   (a != b).sum().item() for a, b in
                   zip(dec["symbol_planes"], golden_probe["symbol_planes"]))),
               "stream_bytes": len(wire)}
        if not (rec["host_vs_kernel_bytes_equal"] and rec["h_hat_equal_y_hat"]):
            raise AssertionError(f"golden encode on the card: {rec}")
        return rec

    # -- phase 4 ----------------------------------------------------------------
    def _write_inputs(self, src):
        """The ten encode inputs as PNGs: heldout val0..7 (256x256), a
        512x512 mosaic of val0..3 and a 256x768 strip of val4..6."""
        import numpy as np
        from PIL import Image
        src.mkdir(parents=True, exist_ok=True)
        val = [np.asarray(Image.open(HELDOUT / f"val{i}.png").convert("RGB"))
               for i in range(8)]
        for i, v in enumerate(val):
            Image.fromarray(v).save(src / f"c_256x256_{i}.png")
        Image.fromarray(np.concatenate([np.concatenate(val[0:2], axis=1),
                                        np.concatenate(val[2:4], axis=1)])
                        ).save(src / "a_512x512.png")
        Image.fromarray(np.concatenate(val[4:7], axis=1)).save(src / "b_256x768.png")

    def encode(self):
        """The flagship encode on real images: the compress CLI over ten
        images (routing "auto"), then encode_only (512x512, 256x768) and
        encode_only_batched (eight 256x256) with the encode kernel and with
        the host coder."""
        import numpy as np
        torch = self.torch

        from sic_tpu_torch import ops
        from sic_tpu_torch.cli._common import load_clip_codec, load_runtime
        from sic_tpu_torch.cli.compress import main as compress_main
        from sic_tpu_torch.config import flagship_spec
        from sic_tpu_torch.container import pack_c2df, unpack_c2df
        from sic_tpu_torch.data import load_image
        spec = flagship_spec()
        t0 = time.perf_counter()
        rt = self.rt = load_runtime(None, spec, device="cuda", stream_part=4)
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in rt.model.parameters())
        clip = load_clip_codec(None, device="cuda")
        src, out_dir = WORK / "encode_in", WORK / "encode_out"
        self._write_inputs(src)
        img = {p.stem: load_image(p) for p in sorted(src.glob("*.png"))}
        group = [f"c_256x256_{i}" for i in range(8)]
        x = {"a_512x512": img["a_512x512"][None], "b_256x768": img["b_256x768"][None],
             "group_of_8": np.stack([img[k] for k in group])}

        def run(mode, probes=None):
            rt.device_entropy = mode
            out = {}
            for stem in ("a_512x512", "b_256x768"):
                out[stem] = rt.encode_only(
                    x[stem], probe=None if probes is None else probes.setdefault(stem, {}))
            out["group_of_8"] = rt.encode_only_batched(
                x["group_of_8"],
                probe=None if probes is None else probes.setdefault("group_of_8", {}))
            torch.cuda.synchronize()
            return out

        # warm-up (cuBLAS/cuDNN handles and heuristics), not counted
        run("device")
        run("host")
        clip.image_to_unit_vec(img["a_512x512"])

        # -- the encode main path: counts from 0, read right after ------------
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        cli = compress_main(["--dataset_dir", str(src), "--save_dir", str(out_dir),
                             "--spec", "flagship", "--device", "cuda"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t1
        encs, probes = {}, {}
        for mode in ("device", "host"):
            probes[mode] = {}
            encs[mode] = run(mode, probes[mode])
        self.counts["encode"] = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        # ---------------------------------------------------------------------
        rt.device_entropy = "auto"

        def streams(mode, key):
            e = encs[mode][key]
            return [d["h_bit_stream"] for d in e] if isinstance(e, list) \
                else [e["h_bit_stream"]]

        bytes_equal = {k: streams("device", k) == streams("host", k) for k in x}
        paths = {m: {k: v["h_path"] for k, v in probes[m].items()} for m in probes}
        # every stream the card wrote decodes back to the encoder's y_hat
        exact = {}
        for stem in ("a_512x512", "b_256x768"):
            dec = {}
            rt.decode_only(**encs["device"][stem], coding_batch=8, probe=dec)
            exact[stem] = bool(torch.equal(dec["h_hat"],
                                           probes["device"][stem]["y_hat"]))
        dec = {}
        rt.decode_only_batched([dict(e, coding_batch=8)
                                for e in encs["device"]["group_of_8"]], probe=dec)
        exact["group_of_8"] = bool(torch.equal(dec["h_hat"],
                                               probes["device"]["group_of_8"]["y_hat"]))
        # the CLI's files: ten streams, ten clip vecs, both index layouts,
        # and its h streams equal to the runtime's for the same images
        cli_h = {}
        for f in sorted((out_dir / "bitstreams").glob("*.c2df")):
            cli_h[f.stem] = unpack_c2df(f)[0]["h_bit_stream"]
        cli_equal = (cli_h.get("a_512x512") == streams("host", "a_512x512")[0]
                     and cli_h.get("b_256x768") == streams("host", "b_256x768")[0]
                     and [cli_h.get(k) for k in group] == streams("host", "group_of_8"))
        n_vecs = len(list((out_dir / "clip_vecs").glob("*.npy")))
        index_files = sorted(p.name for p in (out_dir / "faiss").iterdir())

        timing = self._encode_timing(rt, clip, x, img)
        # the decode phase's requests: the kernel's streams, as files too
        dst = WORK / "flagship_in"
        dst.mkdir(parents=True, exist_ok=True)
        for f in dst.glob("*.c2df"):
            f.unlink()
        reqs = {"a_512x512": (encs["device"]["a_512x512"],
                              probes["device"]["a_512x512"]["y_hat"]),
                "b_256x768": (encs["device"]["b_256x768"],
                              probes["device"]["b_256x768"]["y_hat"])}
        for i in range(4):
            reqs[group[i]] = (encs["device"]["group_of_8"][i],
                              probes["device"]["group_of_8"]["y_hat"][i:i + 1])
        for stem, (enc, y_hat) in reqs.items():
            H, W = enc["img_shape"]
            header = {"version": 2, "image_hw": [H, W], "padding": [0, 0, 0, 0],
                      "z_coder": "rans", "coding_batch": 8}
            (dst / f"{stem}.c2df").write_bytes(pack_c2df(enc, header))
            self.requests[stem] = dict(enc, coding_batch=8, z_coder="rans",
                                       y_hat=y_hat)
        rec = {"spec": "flagship", "params": n_params, "init_s": round(init_s, 3),
               "dtype": "float32", "cli": cli, "cli_s": round(cli_s, 3),
               "cli_files": len(cli_h), "cli_clip_vecs": n_vecs,
               "cli_index_files": index_files,
               "cli_streams_equal_runtime": cli_equal,
               "h_paths": paths, "kernel_vs_host_bytes_equal": bytes_equal,
               "h_hat_bit_exact": exact,
               "stream_bytes": {k: [len(b) for b in streams("device", k)] for k in x},
               "peak_mem_gb": peak_gb, "launches": self.counts["encode"],
               **timing}
        need = ("seq_attention", "window_attention_nhwc", "rans_encode_plane")
        if len(cli_h) != 10 or n_vecs != 10 or not all(bytes_equal.values()) \
                or not all(exact.values()) or not cli_equal \
                or "faiss.index" not in index_files or "index.faiss" not in index_files \
                or min(self.counts["encode"][k] for k in need) < 1 \
                or set(paths["device"].values()) != {"device"}:
            raise AssertionError(f"flagship encode check failed: {rec}")
        return rec

    def _encode_timing(self, rt, clip, x, img, reps=5):
        """Request times (median of ``reps``) with the encode kernel and
        with the host coder, CLIP ms per image, and one profiled 512x512
        encode with the kernel."""
        import statistics
        torch = self.torch

        def median_ms(fn):
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)

        out = {"request_ms_p50": {}}
        for mode in ("device", "host"):
            rt.device_entropy = mode
            out["request_ms_p50"][mode] = {
                "a_512x512": median_ms(lambda: rt.encode_only(x["a_512x512"])),
                "b_256x768": median_ms(lambda: rt.encode_only(x["b_256x768"])),
                "group_of_8": median_ms(lambda: rt.encode_only_batched(x["group_of_8"]))}
        rt.device_entropy = "device"
        out["profile_512x512"] = self._profile(lambda: rt.encode_only(x["a_512x512"]))
        rt.device_entropy = "auto"
        imgs = list(img.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for im in imgs:
            clip.image_to_unit_vec(im)
        out["clip_ms_per_image"] = (time.perf_counter() - t0) * 1e3 / len(imgs)
        return out

    # -- phase 5 ----------------------------------------------------------------
    def flagship(self):
        """The flagship decode of phase 4's kernel-written streams."""
        import numpy as np
        torch = self.torch
        from PIL import Image

        from sic_tpu_torch import ops
        from sic_tpu_torch.cli.decompress import main as decompress_main
        rt = self.rt
        src, dst = WORK / "flagship_in", WORK / "flagship_out"
        requests = {k: {f: v for f, v in e.items() if f != "y_hat"}
                    for k, e in self.requests.items()}
        group = [f"c_256x256_{i}" for i in range(4)]

        def decode_single(stem, probe=None):
            out = rt.decode_only(**requests[stem], output="u8", probe=probe)
            torch.cuda.synchronize()
            return out

        def decode_group(probe=None):
            out = rt.decode_only_batched([requests[s] for s in group],
                                         output="u8", probe=probe)
            torch.cuda.synchronize()
            return out

        # warm-up pass (cuBLAS/cuDNN handles and heuristics), not counted
        for stem in ("a_512x512", "b_256x768"):
            decode_single(stem)
        decode_group()

        # -- the decode main path: counts from 0, read right after --------------
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        probes, ms, u8 = {}, {}, {}
        for stem in ("a_512x512", "b_256x768"):
            probes[stem] = {}
            t1 = time.perf_counter()
            u8[stem] = decode_single(stem, probes[stem])
            ms[stem] = (time.perf_counter() - t1) * 1e3
        probes["group"] = {}
        t1 = time.perf_counter()
        u8["group"] = decode_group(probes["group"])
        ms["group_of_4"] = (time.perf_counter() - t1) * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        t1 = time.perf_counter()
        n_cli = decompress_main(["--dataset_dir", str(src), "--save_dir", str(dst),
                                 "--spec", "flagship", "--device", "cuda"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t1
        self.counts["decode"] = counts = ops.launch_counts()
        # -----------------------------------------------------------------------

        exact = {}
        for stem in ("a_512x512", "b_256x768"):
            exact[stem] = bool(torch.equal(probes[stem]["h_hat"],
                                           self.requests[stem]["y_hat"]))
        exact["group"] = bool(torch.equal(
            probes["group"]["h_hat"],
            torch.cat([self.requests[s]["y_hat"] for s in group])))
        paths = {k: v["h_path"] for k, v in probes.items()}
        timing = self._flagship_timing(requests, group, decode_single, decode_group)
        cli_diff = {}
        for stem in ("a_512x512", "b_256x768"):
            png = np.asarray(Image.open(dst / f"{stem}.png")).astype(np.int32)
            cli_diff[stem] = int(np.abs(png - u8[stem][0].cpu().numpy()).max())
        for i, stem in enumerate(group):
            png = np.asarray(Image.open(dst / f"{stem}.png")).astype(np.int32)
            cli_diff[stem] = int(np.abs(png - u8["group"][i].cpu().numpy()).max())
        rec = {"spec": "flagship", "dtype": "float32", "files": n_cli,
               "stream_bytes": {s: len(e["h_bit_stream"]) for s, e in requests.items()},
               "h_paths": paths, "h_hat_bit_exact": exact,
               "request_ms": ms, "cli_s": round(cli_s, 3), "peak_mem_gb": peak_gb,
               "cli_vs_runtime_max_u8_diff": cli_diff,
               "launches": counts, **timing}
        need = ("seq_attention", "window_attention_nhwc", "rans_decode_plane")
        if n_cli != 6 or not all(exact.values()) \
                or min(counts[k] for k in need) < 1 \
                or paths["a_512x512"] != "device" or max(cli_diff.values()) > 1:
            raise AssertionError(f"flagship decode check failed: {rec}")
        return rec

    def _flagship_timing(self, requests, group, decode_single, decode_group,
                         reps=5):
        """Request times (median of ``reps``), the h-stream chain alone,
        and one profiled 512x512 request: device-busy share and the
        kernels that take the most device time."""
        import statistics
        torch = self.torch
        rt = self.rt

        def median_ms(fn):
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)

        def h_chain(stem):
            e = requests[stem]
            Hf, Wf = e["feat_shape"][1:3]
            return rt.h_coder.decompress_device(
                e["h_bit_stream"], (1, Hf, Wf, rt.spec.quant_dim), coding_batch=8)

        out = {"request_ms_p50": {
            "a_512x512": median_ms(lambda: decode_single("a_512x512")),
            "b_256x768": median_ms(lambda: decode_single("b_256x768")),
            "group_of_4": median_ms(decode_group)},
            "h_chain_ms_p50": {
            "a_512x512_kernel": median_ms(lambda: h_chain("a_512x512")),
            "group_of_4_host": median_ms(lambda: rt.h_coder.decompress_batched(
                [requests[s]["h_bit_stream"] for s in group],
                (1, 8, 8, rt.spec.quant_dim), coding_batch=8))}}

        out["profile_512x512"] = self._profile(lambda: decode_single("a_512x512"))
        out["profile_group_of_4"] = self._profile(decode_group)
        return out

    def _profile(self, fn, top=12):
        """One profiled call (torch.profiler): device time by kernel, and
        the device-busy share of that same trace, the union of its kernel
        intervals over the span from its first event to its last.  The
        profiler slows the host side, so the profiled span is longer than
        an unprofiled request and the share is a lower bound."""
        from torch.profiler import ProfilerActivity, profile
        from torch.autograd import DeviceType
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events() if e.time_range.end > e.time_range.start]
        kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                         if e.device_type == DeviceType.CUDA)
        if not kernels:
            return {"wall_ms_profiled": wall_ms, "device_busy_ms": "not measured"}
        busy_us, cur_s, cur_e = 0.0, *kernels[0]
        for s, e in kernels[1:]:
            if s > cur_e:
                busy_us += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy_us += cur_e - cur_s
        span_us = (max(e.time_range.end for e in events)
                   - min(e.time_range.start for e in events))
        rows = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue  # host ops; their kernels are counted as rows of their own
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0)
            if dev_us > 0:
                rows.append((dev_us, e.key, e.count))
        rows.sort(reverse=True)
        mine = {n: round(sum(us for us, k, _ in rows if k.startswith(f"(anonymous namespace)::{n}")) / 1e3, 4)
                for n in ("seq_attention_kernel", "window_attention_kernel",
                          "rans_decode_kernel", "rans_encode_kernel")}
        return {"wall_ms_profiled": wall_ms, "trace_span_ms": span_us / 1e3,
                "device_busy_ms": busy_us / 1e3,
                "device_busy_share": busy_us / span_us,
                "ported_kernels_ms": mine,
                "top_kernels_ms": [[k[:90], round(us / 1e3, 4), n]
                                   for us, k, n in rows[:top]]}

    # -- phase 6 ----------------------------------------------------------------
    def cpu_compare(self):
        torch = self.torch
        from sic_tpu_torch.models import Codec, CodecRuntime
        rt = self.rt
        spec = rt.spec
        model = Codec(spec)
        model.load_state_dict({k: v.cpu() for k, v in rt.model.state_dict().items()})
        cpu_rt = CodecRuntime(spec, model.eval().requires_grad_(False),
                              stream_part=4, device_entropy="device")
        enc = dict(self._first_256(), output="float")
        gpu_p, cpu_p = {}, {}
        x_gpu = rt.decode_only(**enc, probe=gpu_p).cpu()
        t0 = time.perf_counter()
        x_cpu = cpu_rt.decode_only(**enc, probe=cpu_p)
        cpu_s = time.perf_counter() - t0
        mism = sum(int((a != b).sum()) for a, b in
                   zip(gpu_p["index_planes"], cpu_p["index_planes"]))
        sym_mism = sum(int((a != b).sum()) for a, b in
                       zip(gpu_p["symbol_planes"], cpu_p["symbol_planes"]))
        max_diff = (x_gpu - x_cpu).abs().max().item()
        h_gpu = gpu_p["h_hat"].cpu()
        rec = {"index_plane_mismatches": mism, "symbol_mismatches": sym_mism,
               "max_pixel_diff": max_diff, "bound": CPU_PIXEL_TOL,
               "cpu_paths": cpu_p["h_path"], "cpu_decode_s": round(cpu_s, 3),
               "h_hat_max_diff": (h_gpu - cpu_p["h_hat"]).abs().max().item(),
               # the drift relative to the largest |h_hat|
               "h_hat_rel_diff": ((h_gpu - cpu_p["h_hat"]).abs().max()
                                  / h_gpu.abs().max()).item(),
               "encode": self._cpu_encode(cpu_rt)}
        cpu_rt.close()
        if mism or sym_mism or not max_diff <= CPU_PIXEL_TOL:
            raise AssertionError(f"card vs CPU: {rec}")
        return rec

    def _cpu_encode(self, cpu_rt):
        """One 256x256 image encoded on the card and on the CPU (plain
        versions) with the same weights: the differences in z indices and
        in the symbol and index planes are reported, not asserted (float
        summation order differs)."""
        torch = self.torch
        from sic_tpu_torch.data import load_image
        x = load_image(WORK / "encode_in" / "c_256x256_0.png")[None]
        out = {}
        for name, rt in (("card", self.rt), ("cpu", cpu_rt)):
            xt = torch.from_numpy(x).to(rt.device)
            with torch.no_grad():
                z, h, _ = rt.model.encode_stage(xt * 0.5 + 0.5)
                packed, _ = rt.h_coder.compress_plan(h)
            out[name] = (z.cpu().numpy(), packed.cpu().numpy(), h.cpu())
        (zg, pg, hg), (zc, pc, hc) = out["card"], out["cpu"]
        cpu_rt.device_entropy = "device"
        t0 = time.perf_counter()
        cpu_rt.encode_only(x)
        return {"z_index_diffs": int((zg != zc).sum()), "z_indices": int(zg.size),
                "symbol_diffs": int((pg[:, 0] != pc[:, 0]).sum()),
                "index_diffs": int((pg[:, 1] != pc[:, 1]).sum()),
                "positions": int(pg[:, 0].size),
                "feature_rel_diff": ((hg - hc).abs().max() / hg.abs().max()).item(),
                "cpu_encode_s": round(time.perf_counter() - t0, 3)}

    def _first_256(self):
        from sic_tpu_torch.container import sanitize_enc_result_types, unpack_c2df
        enc, header = unpack_c2df(WORK / "flagship_in" / "c_256x256_0.c2df")
        enc = sanitize_enc_result_types(enc)
        enc["z_coder"] = header["z_coder"]
        enc["coding_batch"] = header["coding_batch"]
        return enc

    def kernels_line(self):
        names = {"seq_attention": ("sic_tpu_torch/csrc/seq_attention.cu",
                                   "sic_tpu/ops/seq_attention.py:35"),
                 "window_attention_nhwc": ("sic_tpu_torch/csrc/window_attention.cu",
                                           "sic_tpu/ops/window_attention.py:142"),
                 "rans_decode_plane": ("sic_tpu_torch/csrc/rans_decode.cu",
                                       "sic_tpu/ops/rans_decode.py:165"),
                 "rans_encode_plane": ("sic_tpu_torch/csrc/rans_encode.cu",
                                       "sic_tpu/ops/rans_encode.py:77")}
        rows = []
        for name, (source, replaces) in names.items():
            k = self.kernels.get(name, {})
            # launches over both main-path runs (encode, then decode)
            launches = sum(c.get(name, 0) for c in self.counts.values())
            rows.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "launches": launches,
                         "max_abs_err": k.get("max_abs_err"), "ms": k.get("ms"),
                         "plain_ms": k.get("plain_ms"), "bound_ms": k.get("bound_ms"),
                         "bound_by": k.get("bound_by"),
                         "library_ms": k.get("library_ms")})
        return {"kernels": rows}


def main() -> int:
    if not (ROOT / "sic_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py must run from a checkout of the repository "
              "(sic_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sic_tpu_torch.models import configure_numerics
    configure_numerics()
    WORK.mkdir(parents=True, exist_ok=True)

    smoke = Smoke(torch)
    smoke.phase("build", smoke.build)
    if smoke.failed:
        return 1
    smoke.phase("kernels", smoke.kernel_checks)
    smoke.phase("golden", smoke.golden)
    smoke.phase("encode", smoke.encode)
    if "encode" not in smoke.failed:
        smoke.phase("flagship", smoke.flagship)
    if not {"encode", "flagship"} & set(smoke.failed):
        smoke.phase("cpu", smoke.cpu_compare)
    if getattr(smoke, "rt", None) is not None:
        smoke.rt.close()
    print(json.dumps(smoke.kernels_line()), flush=True)
    if smoke.failed:
        print(f"failed phases: {smoke.failed}", file=sys.stderr)
        return 1
    print(smoke.card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
