#!/usr/bin/env python3
"""Chip check of the PyTorch port's decode path on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing one JSON line with the card's name and power limit:

1. build   - the three CUDA kernels (one nvcc per source, in parallel) and
             the native rANS coder, from the sources in the checkout;
2. kernels - each kernel against its plain PyTorch version on the card at
             the flagship decode's shapes, with CUDA-event times of the
             kernel, the plain version and, for attention, one
             scaled_dot_product_attention call as a yardstick;
3. golden  - the JAX-encoded tests/fixtures/golden stream through the CLI
             (host coder) and through the rANS kernel, against the
             committed pixels;
4. flagship - seeded flagship model (TiTok-L, fp32); streams made by the
             port's bottleneck host encode (4 substreams, coding batch 8)
             for one 512x512, one 256x768 and four 256x256 requests;
             decode_only / decode_only_batched / the decompress CLI, with
             every h_hat equal to the encoder's y_hat bit for bit and every
             kernel launched on the way;
5. cpu     - the 256x256 request decoded again on the CPU (plain versions):
             CDF-index planes and pixels against the card's.

Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
without a CUDA device, outside the repository, or if any phase fails.
Work files go to chiprun_out/chip_smoke/.
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
        self.counts = None

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

        # kernel 1: trunk (4 tiles of a 512x512 image) and cross blocks
        for tag, (B, S, C, heads) in {"trunk": (4, 289, 1024, 16),
                                      "cross": (4, 545, 768, 12)}.items():
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
        return rec

    # -- phase 4 ----------------------------------------------------------------
    def flagship(self):
        import numpy as np
        torch = self.torch
        from PIL import Image

        from sic_tpu_torch import ops
        from sic_tpu_torch.cli._common import load_runtime
        from sic_tpu_torch.cli.decompress import main as decompress_main
        from sic_tpu_torch.config import flagship_spec
        from sic_tpu_torch.container import pack_c2df
        spec = flagship_spec()
        dev = torch.device("cuda")
        t0 = time.perf_counter()
        rt = self.rt = load_runtime(None, spec, device="cuda", stream_part=4)
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in rt.model.parameters())
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        rng = np.random.default_rng(SEED + 1)
        src, dst = WORK / "flagship_in", WORK / "flagship_out"
        src.mkdir(parents=True, exist_ok=True)
        for f in src.glob("*.c2df"):
            f.unlink()
        requests = {}   # stem -> enc dict (with y_hat)

        def make(stems, B, H, W):
            stack = (H // 256, W // 256)
            y = 3.0 * torch.randn((B, H // 32, W // 32, spec.feat_width),
                                  device=dev, generator=g)
            z = rng.integers(0, spec.titok.codebook_size,
                             (B * stack[0] * stack[1], spec.titok.num_latent_tokens))
            for stem, enc in zip(stems, rt.encode_features(y, stack, z)):
                enc["coding_batch"] = 8
                enc["z_coder"] = "rans"
                requests[stem] = enc
                header = {"version": 2, "image_hw": [H, W], "padding": [0, 0, 0, 0],
                          "z_coder": "rans", "coding_batch": 8}
                wire = {k: v for k, v in enc.items()
                        if k not in ("y_hat", "coding_batch", "z_coder")}
                (src / f"{stem}.c2df").write_bytes(pack_c2df(wire, header))

        make(["a_512x512"], 1, 512, 512)
        make(["b_256x768"], 1, 256, 768)
        group = [f"c_256x256_{i}" for i in range(4)]
        make(group, 4, 256, 256)

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

        # -- the main path: counts from 0, read right after ---------------------
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
                                 "--device", "cuda"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t1
        self.counts = ops.launch_counts()
        # -----------------------------------------------------------------------

        exact = {}
        for stem in ("a_512x512", "b_256x768"):
            exact[stem] = bool(torch.equal(probes[stem]["h_hat"],
                                           requests[stem]["y_hat"]))
        exact["group"] = bool(torch.equal(
            probes["group"]["h_hat"],
            torch.cat([requests[s]["y_hat"] for s in group])))
        paths = {k: v["h_path"] for k, v in probes.items()}
        timing = self._flagship_timing(requests, group, decode_single, decode_group)
        cli_diff = {}
        for stem in ("a_512x512", "b_256x768"):
            png = np.asarray(Image.open(dst / f"{stem}.png")).astype(np.int32)
            cli_diff[stem] = int(np.abs(png - u8[stem][0].cpu().numpy()).max())
        for i, stem in enumerate(group):
            png = np.asarray(Image.open(dst / f"{stem}.png")).astype(np.int32)
            cli_diff[stem] = int(np.abs(png - u8["group"][i].cpu().numpy()).max())
        rec = {"spec": "flagship", "params": n_params, "init_s": round(init_s, 3),
               "dtype": "float32", "files": n_cli,
               "stream_bytes": {s: len(e["h_bit_stream"]) for s, e in requests.items()},
               "h_paths": paths, "h_hat_bit_exact": exact,
               "request_ms": ms, "cli_s": round(cli_s, 3), "peak_mem_gb": peak_gb,
               "cli_vs_runtime_max_u8_diff": cli_diff,
               "launches": self.counts, **timing}
        if n_cli != 6 or not all(exact.values()) or min(self.counts.values()) < 1 \
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
                          "rans_decode_kernel")}
        return {"wall_ms_profiled": wall_ms, "trace_span_ms": span_us / 1e3,
                "device_busy_ms": busy_us / 1e3,
                "device_busy_share": busy_us / span_us,
                "ported_kernels_ms": mine,
                "top_kernels_ms": [[k[:90], round(us / 1e3, 4), n]
                                   for us, k, n in rows[:top]]}

    # -- phase 5 ----------------------------------------------------------------
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
        cpu_rt.close()
        mism = sum(int((a != b).sum()) for a, b in
                   zip(gpu_p["index_planes"], cpu_p["index_planes"]))
        sym_mism = sum(int((a != b).sum()) for a, b in
                       zip(gpu_p["symbol_planes"], cpu_p["symbol_planes"]))
        max_diff = (x_gpu - x_cpu).abs().max().item()
        rec = {"index_plane_mismatches": mism, "symbol_mismatches": sym_mism,
               "max_pixel_diff": max_diff, "bound": CPU_PIXEL_TOL,
               "cpu_paths": cpu_p["h_path"], "cpu_decode_s": round(cpu_s, 3),
               "h_hat_max_diff": (gpu_p["h_hat"].cpu() - cpu_p["h_hat"]).abs().max().item()}
        if mism or sym_mism or not max_diff <= CPU_PIXEL_TOL:
            raise AssertionError(f"card vs CPU: {rec}")
        return rec

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
                                       "sic_tpu/ops/rans_decode.py:165")}
        rows = []
        for name, (source, replaces) in names.items():
            k = self.kernels.get(name, {})
            rows.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces,
                         "launches": (self.counts or {}).get(name, 0),
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
    smoke.phase("flagship", smoke.flagship)
    if "flagship" not in smoke.failed:
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
