#!/usr/bin/env python3
"""Chip check of the PyTorch port on one CUDA card: encode, decode, the
(G, s, d) window-attention op, the HTTP service with search, the evaluate
CLI, the concurrent runtime entry points, reference-format files and YAML
configs, and training.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing one JSON line with the card's name and power limit:

1. build    - the six CUDA kernels (one nvcc per source, in parallel) and
              the native rANS coder, from the sources in the checkout; the
              HGMMA (wgmma) count of the four attention libraries (kernels
              1, 2, 5 and 6), which run split TF32 on the tensor cores,
              must be above 0; a dependent-chain probe
              (csrc/chain_probe.cu) reads the least latency of one step of
              each rANS chain in SM cycles, and nvidia-smi the SM's highest
              clock, for the rANS rows' chain bound;
2. kernels  - each kernel against its plain PyTorch version on the card at
              the flagship's shapes (rANS decode also against the native
              decoder at 4 x 1024, 1 x 4096 and 32 x 256; rANS encode also
              against the native encoder, and through one forced buffer
              overflow; the
              window-attention backward against the plain version's
              autograd at the training shapes, -inf shift masks included;
              the (G, s, d) window attention at bench.py:kernel_check's
              geometry, forward and gradient), with CUDA-event times of
              the kernel, the plain version and, for attention, one
              scaled_dot_product_attention call (its backward alone for
              the backward kernel) as a yardstick, device times (CUDA-graph
              replay, which leaves out the host's cost of a call; for
              SDPA's autograd backward, whose forward lies outside any
              capture, the sum of its kernels in a torch.profiler trace,
              the method named in each row), each attention row's bounds
              on the f32 cores and, as split TF32, on the tensor cores,
              each rANS row's bytes bound and chain bound (the longest
              substream's coded symbols times the probe's step), and its
              error against an f64 reference; every attention kernel
              launched twice on one input must give the same bits;
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
              256x256), every h_hat equal to the encoder's y_hat; the
              pixel decoder and the encoder at 4 and 8 x 256x256 run
              batched and one stream at a time, timed A B B A, and the
              outputs of the two compared (batch invariance);
6. op       - the (G, s, d) window-attention op, forward and gradient, at
              kernel_check's geometry and on one flagship Swin layer's real
              qkv (FeatMerge's shifted feat_in layer on the 512x512
              request, -inf masks included), whose output must agree
              with kernel 2's on the same qkv within GSD_FWD_TOL (one
              tensor-core body, two geometries);
7. serve    - the port's HTTP service in process (flagship spec, seeded
              codec and CLIP, INDEX_DIR at phase 4's faiss/): /compress and
              /decompress against the runtime's encode_only / decode_only,
              four concurrent requests of each byte-equal to the serial
              ones, /search/stream/{c2df,image,text} (the committed
              artifacts_r05 index ranks val3, val4, val6 first; image and
              text hits equal the search CLI's), the search and build CLIs
              on the card equal to their CPU runs, latencies and one
              profiled /decompress; one search wave of 256 queries over
              100k seeded vectors of 512, its top k against a full stable
              sort, timed;
8. surface  - the codec's remaining user surface: the evaluate CLI over
              the eight heldout images (seeded flagship), each record's
              bpps equal to those of encode_only's bytes and its psnr within
              1e-4 dB of decode_only's; decode_only_many (four workers) over
              phase 4's six streams, round_trip_pipelined over three batches
              of four 256x256 images and encode_decode_many over the eight,
              each bit for bit against its serial counterpart, wall times
              of both sides; a torchac-format (reference) file of the
              512x512 mosaic, written by the compress CLI's compress_dir
              with and without z_coder in its header, decoding by the
              decompress CLI's decompress_dir to the PNG bytes of the
              rans-format file; configs/config_small_r4.yaml through the
              compress and decompress CLIs (--base_config) and the service
              (BASE_CONFIG), the service's answers byte-equal to the CLIs'
              files; the train CLI with tests/fixtures/config_tiny.yaml,
              one epoch a stage (kernel 5 launched);
9. train    - the seeded flagship trained through create_train_state and
              Trainer at 256 px, batch 2, on the heldout images: four steps
              of each stage (feat_wo_bpp, feat, pix) and an eval step after
              each, every loss finite, frozen leaves bit-unchanged,
              trainable leaves moved, the VQGAN decoder side unchanged
              after the feat stages and moved after pix, the discriminator
              moved; then the train CLI at the 512-px preset (starts in
              pix) for one epoch, its `last` checkpoint and
              deploy_params.npz, and one image compressed and decompressed
              with those params, h_hat equal to the encoder's y_hat; step
              times, peak memory and one profiled pix step;
10. cpu     - the first 256x256 request decoded again on the CPU (plain
              versions): CDF-index planes and pixels against the card's;
              one 256x256 image encoded on the CPU, its differences from
              the card's encode reported; and one tiny-spec feat step and
              pix step on the card against the CPU (losses within 1e-4
              relative, each leaf's gradient within 1e-3 of its norm; the
              pix step within 1e-3 and 5e-3, its adaptive weight being
              ill-conditioned in f32), the CPU's own spread (one thread
              against all) reported beside them.

Each path's launch counts are set to 0 just before it is driven (phase 4
for the encode, phase 5 for the decode, phase 6 for the op, phase 7 for
serving, phase 8 for the surface, phase 9 for training) and read just after; every kernel of the
path must have launched, and the (G, s, d) kernel on no model path.  Then
a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
without a CUDA device, outside the repository, or if any phase fails.
Work files go to ``WORK`` below.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
import uuid
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "chiprun_out" / "chip_smoke"
# training checkpoints (gigabytes at flagship width): beside the checkout,
# git-ignored, removed at the end
TRAIN_WORK = ROOT / ".chip_smoke_train"
GOLDEN = ROOT / "tests" / "fixtures" / "golden"
HELDOUT = ROOT / "artifacts_r05" / "heldout"

F32_TFLOPS = 67e12      # H100 SXM f32 outside the tensor cores
TF32_TFLOPS = 495e12    # H100 SXM dense TF32 on the tensor cores
HBM_BYTES_S = 3.35e12   # H100 SXM HBM3
CHAIN_PROBE_STEPS = 1 << 16   # steps of each dependent-chain probe
ATTN_TOL = 1e-4         # kernel vs plain, fp32: only the summation order differs
# backward kernel vs the plain version's autograd, relative to the largest
# magnitude: f32 summation order, and dbias summed over batch, heads, windows
BWD_TOL = 1e-4
TRAIN_LOSS_TOL = 1e-4   # card vs CPU training step: losses, relative
TRAIN_GRAD_TOL = 1e-3   # card vs CPU: each leaf's gradient, relative to its norm
# the pix step's limits: its adaptive weight is a ratio of two gradient
# norms of a seeded network, and f32 summation order alone moves it.  On an
# H100 80GB HBM3 at 700 W the card was off by 3.1e-4 (losses) and 2.2e-3
# (worst leaf), the CPU with one thread against all by 4.2e-4 and 3.8e-3.
PIX_LOSS_TOL = 1e-3
PIX_GRAD_TOL = 5e-3
CPU_PIXEL_TOL = 1e-3    # card vs CPU decode of the flagship, [-1, 1] floats
# the (G, s, d) window-attention kernel vs its plain version: the forward
# within this share of the output's largest magnitude, each gradient (q, k,
# v, bias) within GSD_GRAD_TOL of its own largest magnitude; f32 summation
# order only
GSD_FWD_TOL = 1e-5
GSD_GRAD_TOL = 1e-4
# the JAX CLI's three best scores for val3.c2df over artifacts_r05/faiss
R05_VAL3_TOP3 = (("val3", 0.99724), ("val4", 0.99316), ("val6", 0.99262))
SEED = 0


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def _multipart(filename: str, payload: bytes):
    """A multipart/form-data body with one ``file`` field, and its type."""
    boundary = uuid.uuid4().hex
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{filename}\"\r\nContent-Type: application/octet-stream"
            f"\r\n\r\n").encode() + payload + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


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

    def device_ms(self, fn, iters=20):
        """Device time of one call: ``iters`` calls captured in a CUDA graph
        and replayed, so the host's cost of a call (the Python wrapper, the
        tensor-map encode, the launch) is left out."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up off the capture
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        del graph
        return a.elapsed_time(b) / iters

    def profiled_device_ms(self, fn, iters=10, by_kernel=False):
        """Device time of one call as the sum of its device activity
        (kernels, copies, fills) in a torch.profiler trace of ``iters``
        calls, for calls a CUDA graph does not capture (an autograd
        backward whose forward ran outside the capture); with
        ``by_kernel`` also each kernel's share, by name."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        names = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                # "void (anonymous namespace)::bwd_stats_kernel<2>(...)" -> the name
                key = e.name.replace("(anonymous namespace)::", "").split("(")[0]
                key = key.split(" ")[-1].split("::")[-1][:60]
                names[key] = names.get(key, 0.0) + (e.time_range.end - e.time_range.start)
        total = sum(names.values()) / 1e3 / iters if names else "not measured"
        if not by_kernel:
            return total
        return total, {k: v / 1e3 / iters for k, v in names.items()}

    @staticmethod
    def bound(flops, nbytes):
        t_ops, t_bytes = flops / F32_TFLOPS, nbytes / HBM_BYTES_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    @staticmethod
    def tc_bound(flops):
        """Least time for the same f32 work as split TF32 (three TF32
        products per product) on the tensor cores, ms."""
        return 3 * flops / TF32_TFLOPS * 1e3

    @staticmethod
    def hgmma_count(name):
        """HGMMA (wgmma) instructions in kernel library ``name``'s SASS."""
        from sic_tpu_torch.ops import cuda_build
        cuobjdump = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
        out = subprocess.run([str(cuobjdump), "-sass", str(cuda_build.lib_path(name))],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise RuntimeError(f"cuobjdump -sass {name}: {out.stderr.strip()}")
        return sum("HGMMA" in ln for ln in out.stdout.splitlines())

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
        reports = cuda_build.build(cuda_build.KERNELS + ("chain_probe",))
        th.join()
        if "error" in native:
            raise native["error"]
        regs = {n: [ln.strip() for ln in r.splitlines()
                    if "registers" in ln or "spill" in ln or "entry function" in ln]
                for n, r in reports.items()}
        for n in cuda_build.KERNELS:
            cuda_build.load(n)
        # the attention kernels (1, 2, 5, 6) run on the tensor cores: their
        # libraries hold wgmma
        hgmma = {n: self.hgmma_count(n) for n in (
            "seq_attention", "window_attention", "window_attention_bwd",
            "window_attention_gsd")}
        if not all(c > 0 for c in hgmma.values()):
            raise AssertionError(f"no HGMMA instruction in {hgmma}")
        self.chain = self.chain_probe()
        return {"built": sorted(reports), "build_s": round(time.perf_counter() - t0, 3),
                "ptxas": regs, "hgmma": hgmma, "chain_probe": self.chain}

    def chain_probe(self):
        """The least latency of one step of each rANS chain on this card,
        in SM cycles, from csrc/chain_probe.cu (one warp, 2^16 dependent
        steps): decode = a shared-memory load picked by the state plus one
        integer multiply-add, encode = a high multiply plus a multiply-add;
        and the SM's highest clock, which turns cycles into the least
        time."""
        import ctypes
        import numpy as np
        torch = self.torch
        from sic_tpu_torch.ops import cuda_build
        fn = cuda_build.load("chain_probe").sic_chain_probe
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = torch.zeros(4, dtype=torch.int64, device="cuda")
        best = None
        for _ in range(3):   # the first call also loads the module
            cuda_build.check_launch(
                fn(out.data_ptr(), CHAIN_PROBE_STEPS,
                   torch.cuda.current_stream().cuda_stream), "chain_probe")
            torch.cuda.synchronize()
            cyc = out.cpu().numpy()[:2] / CHAIN_PROBE_STEPS
            best = cyc if best is None else np.minimum(best, cyc)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
        mhz = float(smi.stdout.strip().splitlines()[0])
        return {"decode_step_cycles": float(best[0]),
                "encode_step_cycles": float(best[1]),
                "sm_clock_max_mhz": mhz, "steps": CHAIN_PROBE_STEPS}

    def chain_bound(self, steps, kind):
        """Least time of ``steps`` dependent steps of the ``kind`` chain
        (decode or encode), ms."""
        c = self.chain
        return steps * c[f"{kind}_step_cycles"] / (c["sm_clock_max_mhz"] * 1e3)

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
            ref = self._seq_f64(qkv, scale, heads)
            d = C // heads
            q, k, v = (t.view(B, S, heads, d).transpose(1, 2)
                       for t in qkv.split(C, dim=-1))
            lib = F.scaled_dot_product_attention(q, k, v, scale=scale)
            lib_err = (lib.transpose(1, 2).reshape(B, S, C) - p_out).abs().max().item()
            rec = {
                "shape": [B, S, 3 * C], "heads": heads, "max_abs_err": err,
                "library_max_abs_err": lib_err,
                "f64_max_abs_err": (k_out.double() - ref).abs().max().item(),
                "plain_f64_max_abs_err": (p_out.double() - ref).abs().max().item(),
                "ms": self.time_ms(lambda: ops.seq_attention(qkv, scale, heads)),
                "plain_ms": self.time_ms(lambda: ops.seq_attention_plain(qkv, scale, heads)),
                "library_ms": self.time_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
                "device_ms": self.device_ms(lambda: ops.seq_attention(qkv, scale, heads)),
                "library_device_ms": self.device_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
            }
            rec["bound_ms"], rec["bound_by"] = self.bound(
                4 * B * heads * S * S * d, B * S * 4 * C * 4)
            rec["tc_bound_ms"] = self.tc_bound(4 * B * heads * S * S * d)
            rec["deterministic"] = torch.equal(k_out, ops.seq_attention(qkv, scale, heads))
            if not (err <= ATTN_TOL and rec["deterministic"]):
                raise AssertionError(f"seq_attention {tag}: max abs err {err}, "
                                     f"deterministic {rec['deterministic']}")
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
                ref = self._window_f64(qkv, bias, scale, heads)
                # SDPA yardstick on pre-windowed (B*nW, heads, s, d) tensors;
                # the relayout into that form is not timed
                d = C // heads
                t = qkv.reshape(1, 2, ws, 2, ws, 3, heads, d).permute(
                    5, 0, 1, 3, 6, 2, 4, 7).reshape(3, 4, heads, s, d).contiguous()
                mask = bias.expand(4, s, s)[:, None]
                rec = {
                    "shape": [1, 32, 32, 3 * C], "heads": heads, "nB": nB,
                    "max_abs_err": err,
                    "f64_max_abs_err": (k_out.double() - ref).abs().max().item(),
                    "plain_f64_max_abs_err": (p_out.double() - ref).abs().max().item(),
                    "ms": self.time_ms(lambda: ops.window_attention_nhwc(qkv, bias, scale, heads)),
                    "plain_ms": self.time_ms(
                        lambda: ops.window_attention_nhwc_plain(qkv, bias, scale, heads)),
                    "library_ms": self.time_ms(lambda: F.scaled_dot_product_attention(
                        t[0], t[1], t[2], attn_mask=mask, scale=scale)),
                    "device_ms": self.device_ms(
                        lambda: ops.window_attention_nhwc(qkv, bias, scale, heads)),
                    "library_device_ms": self.device_ms(lambda: F.scaled_dot_product_attention(
                        t[0], t[1], t[2], attn_mask=mask, scale=scale)),
                }
                rec["bound_ms"], rec["bound_by"] = self.bound(
                    4 * 4 * heads * s * s * d, 32 * 32 * 4 * C * 4 + nB * s * s * 4)
                rec["tc_bound_ms"] = self.tc_bound(4 * 4 * heads * s * s * d)
                rec["deterministic"] = torch.equal(
                    k_out, ops.window_attention_nhwc(qkv, bias, scale, heads))
                if not (err <= ATTN_TOL and rec["deterministic"]):
                    raise AssertionError(f"window_attention C={C} nB={nB}: err {err}, "
                                         f"deterministic {rec['deterministic']}")
                out[f"window_attention_c{C}_nb{nB}"] = rec
        self.kernels["window_attention_nhwc"] = out["window_attention_c768_nb4"]
        out["window_attention_bwd"] = bwd = self._window_bwd_checks(g)
        self.kernels["window_attention_nhwc_bwd"] = bwd["256px_c768_nb1"]
        out["window_attention_gsd"] = self.kernels["window_attention"] = \
            self._gsd_check(*self._gsd_bench_inputs(g), 64 ** -0.5)

        out["rans_decode"] = dec = {
            f"{B * nparts}x{npos}": self._rans_check(B, nparts, npos)
            for B, nparts, npos in ((1, 4, 1024), (1, 1, 4096), (8, 4, 256))}
        self.kernels["rans_decode_plane"] = dec["4x1024"]
        enc = {f"{S}x{npos}": self._rans_encode_check(S, npos)
               for S, npos in ((4, 1024), (32, 256))}
        # the same plane with no escapes: how much of the time the escapes'
        # operations take; and one position a plane: the launch and the
        # CDF-table copy alone
        enc["4x1024_no_escapes"] = self._rans_encode_check(4, 1024, escape_rate=0.0)
        enc["4x1"] = self._rans_encode_check(4, 1, escape_rate=0.0)
        out["rans_encode"] = enc
        out["rans_encode_overflow"] = self._rans_encode_overflow()
        self.kernels["rans_encode_plane"] = enc["4x1024"]
        return out

    @staticmethod
    def _seq_f64(qkv, scale, heads):
        """Kernel 1's function in f64: the accuracy reference."""
        B, S, c3 = qkv.shape
        C = c3 // 3
        q, k, v = (t.reshape(B, S, heads, C // heads).transpose(1, 2).double()
                   for t in qkv.split(C, dim=-1))
        p = (q * scale @ k.transpose(-1, -2)).softmax(-1)
        return (p @ v).transpose(1, 2).reshape(B, S, C)

    def _window_f64(self, qkv, bias, scale, heads):
        """Kernel 2's function in f64: the accuracy reference."""
        B, H, W, c3 = qkv.shape
        C, ws = c3 // 3, int(round(bias.shape[-1] ** 0.5))
        nwh, nww, d = H // ws, W // ws, C // heads
        t = qkv.double().reshape(B, nwh, ws, nww, ws, 3, heads, d).permute(
            5, 0, 6, 1, 3, 2, 4, 7).reshape(3, B, heads, nwh * nww, ws * ws, d)
        win = self.torch.arange(nwh * nww, device=bias.device) % bias.shape[0]
        p = (t[0] * scale @ t[1].transpose(-1, -2) + bias.double()[win]).softmax(-1)
        o = (p @ t[2]).reshape(B, heads, nwh, nww, ws, ws, d)
        return o.permute(0, 2, 4, 3, 5, 1, 6).reshape(B, H, W, C)

    def _window_bwd_checks(self, g):
        """Kernel 5 against the plain version's autograd at the training
        path's shapes: the 256-px detail branch and FeatMerge (one window
        a map, nB 1, also with the shifted layers' -inf masks) and the
        512-px maps (2x2 windows, nB 1 and nB 4), batch 1 and 2."""
        torch = self.torch
        import torch.nn.functional as F

        from sic_tpu_torch import ops
        from sic_tpu_torch.models.swin import _full_shift_mask
        dev = torch.device("cuda")
        ws, s, scale = 16, 256, 64 ** -0.5
        cases = {"256px_c768_nb1": (2, 16, 16, 768, False),
                 "256px_c1024_nb1": (2, 16, 16, 1024, False),
                 "256px_c1024_nb1_shifted": (2, 16, 16, 1024, True),
                 "512px_c768_nb1": (2, 32, 32, 768, False),
                 "512px_c768_nb4": (2, 32, 32, 768, True),
                 "512px_c1024_nb4_b1": (1, 32, 32, 1024, True)}
        out = {}
        for tag, (B, H, W, C, shifted) in cases.items():
            heads, d = C // 64, 64
            nwh, nww = H // ws, W // ws
            nW = nwh * nww
            qkv = torch.randn((B, H, W, 3 * C), device=dev, generator=g)
            gout = torch.randn((B, H, W, C), device=dev, generator=g)
            bias = torch.randn((1, s, s), device=dev, generator=g)
            if shifted:
                bias = (bias + torch.from_numpy(_full_shift_mask(nwh, nww, ws))
                        .to(dev)).contiguous()
            nB = bias.shape[0]
            dq, db = ops.window_attention_nhwc_bwd(qkv, bias, gout, scale, heads)
            pq, pb = ops.window_attention_nhwc_bwd_plain(qkv, bias, gout, scale, heads)
            abs_err = max((dq - pq).abs().max().item(), (db - pb).abs().max().item())
            err_q = ((dq - pq).abs().max() / pq.abs().max()).item()
            err_b = ((db - pb).abs().max() / pb.abs().max()).item()
            finite = bool(torch.isfinite(dq).all() and torch.isfinite(db).all())
            again = ops.window_attention_nhwc_bwd(qkv, bias, gout, scale, heads)
            deterministic = torch.equal(dq, again[0]) and torch.equal(db, again[1])
            fq, fb = self._window_bwd_f64(qkv, bias, gout, scale, heads)
            f64 = {"f64_dqkv_rel_err": self._rel(dq, fq), "f64_dbias_rel_err": self._rel(db, fb),
                   "plain_f64_dqkv_rel_err": self._rel(pq, fq),
                   "plain_f64_dbias_rel_err": self._rel(pb, fb)}
            del fq, fb, again
            # SDPA yardstick: its backward alone, on pre-windowed
            # (B*nW, heads, s, d) tensors and the bias as a float mask
            t = qkv.reshape(B, nwh, ws, nww, ws, 3, heads, d).permute(
                5, 0, 1, 3, 6, 2, 4, 7).reshape(3, B * nW, heads, s, d)
            q, k, v = (t[i].contiguous().requires_grad_(True) for i in range(3))
            leaf = bias.clone().requires_grad_(True)
            win = torch.arange(B * nW, device=dev) % nW % nB
            lib_out = F.scaled_dot_product_attention(q, k, v, attn_mask=leaf[win][:, None],
                                                     scale=scale)
            lib_g = torch.randn_like(lib_out)

            def kernel():
                return ops.window_attention_nhwc_bwd(qkv, bias, gout, scale, heads)

            def library():
                return torch.autograd.grad(lib_out, (q, k, v, leaf), lib_g,
                                           retain_graph=True)

            rec = {"shape": [B, H, W, 3 * C], "heads": heads, "nB": nB,
                   "shift_masks": shifted, "max_abs_err": abs_err,
                   "dqkv_rel_err": err_q, "dbias_rel_err": err_b, **f64,
                   "deterministic": deterministic,
                   "ms": self.time_ms(kernel, iters=10),
                   "plain_ms": self.time_ms(lambda: ops.window_attention_nhwc_bwd_plain(
                       qkv, bias, gout, scale, heads), iters=10),
                   "library_ms": self.time_ms(library, iters=10),
                   "device_ms": self.device_ms(kernel),
                   "device_method": "cuda_graph",
                   # SDPA's backward, and the kernel the same way beside it
                   "library_device_ms": self.profiled_device_ms(library),
                   "library_device_method": "profiler"}
            rec["profiler_device_ms"], rec["passes_device_ms"] = \
                self.profiled_device_ms(kernel, by_kernel=True)
            rec["bound_ms"], rec["bound_by"] = self.bound(
                10 * B * nW * heads * s * s * d,
                (B * H * W * (3 * C + C + 3 * C) + 2 * nB * s * s) * 4)
            rec["tc_bound_ms"] = self.tc_bound(10 * B * nW * heads * s * s * d)
            if not (finite and err_q <= BWD_TOL and err_b <= BWD_TOL and deterministic):
                raise AssertionError(f"window_attention_bwd {tag}: {rec}")
            out[tag] = rec
        return out

    @staticmethod
    def _rel(got, want):
        """Largest difference relative to the largest magnitude of ``want``."""
        return ((got.double() - want).abs().max() / want.abs().max()).item()

    def _window_bwd_f64(self, qkv, bias, g, scale, heads):
        """Kernel 5's function in f64: the VJP of :meth:`_window_f64`."""
        torch = self.torch
        a = qkv.detach().double().requires_grad_(True)
        b = bias.detach().double().requires_grad_(True)
        return torch.autograd.grad(self._window_f64(a, b, scale, heads), (a, b),
                                   g.double())

    @staticmethod
    def _gsd_f64(q, k, v, bias, scale):
        """Kernel 6's function in f64."""
        G, s, _ = q.shape
        nW = bias.shape[0]
        dots = (q.double() * scale) @ k.double().transpose(-1, -2)
        dots = (dots.reshape(G // nW, nW, s, s) + bias.double()).reshape(G, s, s)
        return dots.softmax(-1) @ v.double()

    def _gsd_bench_inputs(self, g):
        """bench.py:kernel_check's geometry: G 32, s 256, d 64, nW 2,
        unit-normal q, k, v and bias."""
        torch = self.torch
        dev = torch.device("cuda")
        q, k, v = (torch.randn((32, 256, 64), device=dev, generator=g)
                   for _ in range(3))
        return q, k, v, torch.randn((2, 256, 256), device=dev, generator=g)

    def _gsd_grads(self, fn, q, k, v, bias, scale):
        """fn(q, k, v, bias) and the autograd gradient of sum(sin(out)) for
        all four inputs."""
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v, bias)]
        out = fn(*leaves, scale)
        return out.detach(), self.torch.autograd.grad(out.sin().sum(), leaves)

    def _gsd_check(self, q, k, v, bias, scale):
        """Kernel 6 against its plain version on the card: the forward, and
        the autograd gradient of sum(sin(out)) for q, k, v and bias (the
        kernel's autograd Function, whose backward is the plain f32
        recompute, against autograd through the plain forward); CUDA-event
        times of the kernel, the plain version and one SDPA call with the
        bias as a float mask."""
        torch = self.torch
        import torch.nn.functional as F

        from sic_tpu_torch import ops
        G, s, d = q.shape
        nW = bias.shape[0]
        out, grads = self._gsd_grads(ops.window_attention, q, k, v, bias, scale)
        ref, want = self._gsd_grads(ops.window_attention_plain, q, k, v, bias, scale)
        err = (out - ref).abs().max().item()
        fwd_rel = err / ref.abs().max().item()
        grad_rel = {n: ((a - b).abs().max() / b.abs().max()).item()
                    for n, a, b in zip("qkvb", grads, want)}
        finite = bool(torch.isfinite(out).all()) and all(
            bool(torch.isfinite(a).all()) for a in grads)
        qb, kb, vb = (t.view(G // nW, nW, s, d) for t in (q, k, v))
        mask = bias[None]
        f64 = self._gsd_f64(q, k, v, bias, scale)

        def kernel():
            return ops.window_attention(q, k, v, bias, scale)

        def library():
            return F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask, scale=scale)

        rec = {"shape": [G, s, d], "nW": nW, "max_abs_err": err,
               "fwd_rel_err": fwd_rel, "grad_rel_err": grad_rel,
               "f64_fwd_rel_err": self._rel(out, f64),
               "plain_f64_fwd_rel_err": self._rel(ref, f64),
               "deterministic": torch.equal(kernel(), kernel()),
               "ms": self.time_ms(kernel),
               "plain_ms": self.time_ms(
                   lambda: ops.window_attention_plain(q, k, v, bias, scale)),
               "library_ms": self.time_ms(library),
               "device_ms": self.device_ms(kernel),
               "library_device_ms": self.device_ms(library),
               "device_method": "cuda_graph"}
        rec["bound_ms"], rec["bound_by"] = self.bound(
            4 * G * s * s * d, (4 * G * s * d + nW * s * s) * 4)
        rec["tc_bound_ms"] = self.tc_bound(4 * G * s * s * d)
        if not (finite and fwd_rel <= GSD_FWD_TOL and rec["deterministic"]
                and max(grad_rel.values()) <= GSD_GRAD_TOL):
            raise AssertionError(f"window_attention (G, s, d): {rec}")
        return rec

    @staticmethod
    def _rans_planes(rng, t, S, npos, escape_rate, esc_lo, esc_hi):
        """Four (sym, idx) planes of S substreams x npos positions: 20%
        skipped, escapes drawn from [esc_lo, esc_hi) at ``escape_rate``,
        else every symbol inside its row's coded range."""
        import numpy as np
        planes = []
        for _ in range(4):
            idx = rng.integers(0, t.levels, (S, npos)).astype(np.int16)
            idx[rng.random((S, npos)) < 0.2] = -1
            live = idx >= 0
            off = t.offset[np.maximum(idx, 0)]
            top = t.cdf_length[np.maximum(idx, 0)] - 2     # the escape slot
            if escape_rate:
                sym = rng.integers(-6, 7, (S, npos)).astype(np.int16)
                esc = rng.random((S, npos)) < escape_rate
                sym[esc] = rng.integers(esc_lo, esc_hi,
                                        int(esc.sum())).astype(np.int16)
            else:
                sym = (off + (rng.random((S, npos)) * top).astype(np.int64)).astype(np.int16)
            sym[~live] = 0
            planes.append((sym, idx))
        return planes

    @staticmethod
    def _coded_steps(planes, t):
        """(coded symbols, escaped positions) of each plane's longest
        substream and in all: a coded symbol is one dependent step of
        either chain (the bypass steps of escapes, cheaper, are left out of
        the chain bound)."""
        import numpy as np
        longest, escaped = [], 0
        for sym, idx in planes:
            live = idx >= 0
            longest.append(int(live.sum(axis=1).max()))
            value = sym.astype(np.int64) - t.offset[np.maximum(idx, 0)]
            top = t.cdf_length[np.maximum(idx, 0)] - 2
            escaped += int((live & ((value < 0) | (value >= top))).sum())
        return float(np.mean(longest)), escaped

    def _rans_check(self, B, nparts, npos):
        """Four planes of B images x nparts substreams x npos positions (4 x
        1024: one 512x512 request; 1 x 4096: a 512x512 stream of one
        substream, as the JAX CodecRuntime writes by default; 32 x 256:
        eight 256x256), written by the native encoder, escapes included,
        decoded by the kernel with its state carried across the planes:
        symbols and states against the native decoder and the plain
        version."""
        import numpy as np
        torch = self.torch
        from sic_tpu_torch import ops
        from sic_tpu_torch.entropy import EntropyCoder, build_gaussian_tables
        from sic_tpu_torch.ops.rans_decode import words_tensor
        t = build_gaussian_tables("gaussian")
        S = B * nparts
        # the seed and escapes of the earlier 4 x 1024 check, whose planes
        # these are at that shape
        rng = np.random.default_rng(SEED)
        planes = self._rans_planes(rng, t, S, npos, 0.05, -4000, 4000)
        streams, parts, host = [], [], [[] for _ in planes]
        for b in range(B):
            coder = EntropyCoder(nparts)
            grp = coder.add_cdf(t.quantized_cdf, t.cdf_length, t.offset)
            coder.reset()
            rows = slice(b * nparts, (b + 1) * nparts)
            for sym, idx in planes:
                coder.encode_with_indexes(sym[rows].reshape(-1), idx[rows].reshape(-1), grp)
            coder.flush()
            stream = coder.get_encoded_stream()
            streams.append(stream)
            parts += ops.split_substreams(stream)
            coder.set_stream(stream)
            for p, (_sym, idx) in enumerate(planes):
                host[p].append(coder.decode_stream(idx[rows].reshape(-1), grp)
                               .astype(np.int32).reshape(nparts, npos))
        host = [np.concatenate(h) for h in host]

        dev = torch.device("cuda")
        words_np, lens_np, state_np = ops.pack_substreams(parts)
        words = words_tensor(words_np, dev)
        lens = torch.from_numpy(lens_np.reshape(-1)).to(dev)
        tables = [torch.from_numpy(a.astype(np.int32)).to(dev)
                  for a in (t.quantized_cdf, t.cdf_length, t.offset)]
        rows = [torch.from_numpy(idx.astype(np.int32)).to(dev) for _sym, idx in planes]
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
        mism = sum(int((k.cpu().numpy() != h).sum()) for k, h in zip(k_syms, host))
        state_eq = bool(torch.equal(k_st, p_st)) and all(
            torch.equal(a, b) for a, b in zip(k_syms, p_syms))
        # a fully decoded stream ends where its encoder started: x = L and
        # every byte consumed
        final = k_st.cpu().numpy()
        end_ok = bool((final[:, 0] == 1 << 23).all()
                      and (final[:, 1] == lens_np[:, 0]).all())
        ms = self.time_ms(lambda: run(ops.rans_decode_plane), iters=10) / 4
        device_ms = self.device_ms(lambda: run(ops.rans_decode_plane), iters=5) / 4
        # one plane's bytes, as ``ms`` is one plane's time: indexes in,
        # symbols out, the state in and out, the CDF table, and a quarter
        # of the stream bytes the four planes consumed
        consumed = int((final[:, 1] - state_np[:, 1]).sum())
        nbytes = (2 * S * npos * 4 + consumed / 4 + 4 * S * 8
                  + t.quantized_cdf.size * 4)
        bound_ms, bound_by = self.bound(0, nbytes)
        steps, escaped = self._coded_steps(planes, t)
        if mism or not state_eq or not end_ok:
            raise AssertionError(f"rans_decode {S}x{npos}: {mism} symbol mismatches, "
                                 f"state equal {state_eq}, end state ok {end_ok}")
        return {"substreams": S, "npos": npos,
                "stream_bytes": sum(len(s_) for s_ in streams),
                "stream_bytes_consumed": consumed, "escapes": escaped,
                "max_abs_err": 0, "symbol_mismatches": mism,
                "ms": ms, "device_ms": device_ms, "device_method": "cuda_graph",
                "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "coded_steps_longest": steps,
                "chain_bound_ms": self.chain_bound(steps, "decode")}

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
        planes = self._rans_planes(rng, t, S, npos, escape_rate, -30000, 30001)
        steps, n_esc = self._coded_steps(planes, t)
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
        device_ms = self.device_ms(lambda: run(ops.rans_encode_plane), iters=5) / 4
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
                "ms": ms, "device_ms": device_ms, "device_method": "cuda_graph",
                "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "coded_steps_longest": steps,
                "chain_bound_ms": self.chain_bound(steps, "encode")}

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
        clip = self.clip = load_clip_codec(None, device="cuda")
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
        self.group_x = x["group_of_8"]
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
        out["network_batching"] = self._network_batching(requests, group)
        return out

    def _network_batching(self, requests, group, rounds=3):
        """The network passes of a group of 256x256 streams, the pixel
        decoder (four streams, and the four twice) and the encoder (four and
        eight images), run as one batch (A) and one stream at a time (B),
        timed A B B A (CUDA events, ``rounds`` calls a reading), and the
        batch's outputs against the single passes' (batch invariance)."""
        import numpy as np
        torch = self.torch
        from sic_tpu_torch.models.codec import to_u8
        rt, model = self.rt, self.rt.model
        probe = {}
        rt.decode_only_batched([requests[s] for s in group], probe=probe)
        n_latent = int(requests[group[0]]["z_indices_shape"][-1])
        z4 = torch.cat([torch.from_numpy(rt._decode_z(
            requests[s]["z_bit_stream"], requests[s]["token_length"], "rans"
        ).astype(np.int64).reshape(-1, n_latent)) for s in group]).cuda()
        h4, stack = probe["h_hat"], requests[group[0]]["stack_shape"]
        nt = z4.shape[0] // len(group)
        x8 = torch.from_numpy(self.group_x).cuda() * 0.5 + 0.5

        def decode(b, batched):
            z, h = torch.cat([z4] * (b // 4)), torch.cat([h4] * (b // 4))
            if batched:
                return model.decode_stage(z, h, stack)
            return torch.cat([model.decode_stage(z[i * nt:(i + 1) * nt], h[i:i + 1], stack)
                              for i in range(b)])

        def encode(b, batched):
            if batched:
                return model.encode_stage(x8[:b])[:2]
            outs = [model.encode_stage(x8[i:i + 1])[:2] for i in range(b)]
            return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

        out = {}
        with torch.no_grad():
            for name, fn in (("decode", decode), ("encode", encode)):
                for b in (4, 8):
                    ms = {True: [], False: []}
                    for batched in (True, False, False, True):
                        ms[batched].append(self.time_ms(lambda: fn(b, batched),
                                                        iters=rounds, warmup=1))
                    one, per = fn(b, True), fn(b, False)
                    row = {"batched_ms": ms[True], "per_stream_ms": ms[False]}
                    if name == "decode":
                        row["max_abs_diff"] = (one - per).abs().max().item()
                        row["u8_pixels_differing"] = int((to_u8(one) != to_u8(per)).sum())
                    else:
                        row["z_equal"] = bool(torch.equal(one[0], per[0]))
                        row["h_max_abs_diff"] = (one[1] - per[1]).abs().max().item()
                        row["y_hat_equal"] = bool(torch.equal(
                            rt.h_coder.compress_plan(one[1])[1],
                            rt.h_coder.compress_plan(per[1])[1]))
                    out[f"{name}_{b}x256x256"] = row
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
        kernel_names = {"seq_attention": ("seq_attention_kernel",),
                        "window_attention_nhwc": ("window_attention_kernel",),
                        "window_attention_nhwc_bwd": ("bwd_stats_kernel", "bwd_dkdv_kernel",
                                                      "bwd_dq_kernel", "bwd_dbias_kernel"),
                        "rans_decode_plane": ("rans_decode_kernel",),
                        "rans_encode_plane": ("rans_encode_kernel",),
                        "window_attention": ("window_attention_gsd_kernel",)}
        # (kernel 5's four passes: the stats pass on the forward body, dk and
        # dv, dq, dbias; all but the last on the tensor cores) a template
        # kernel's name starts with its return type: "void (anonymous
        # namespace)::seq_attention_kernel<2>(...)"
        mine = {n: round(sum(us for us, k, _ in rows if any(
                    f"(anonymous namespace)::{f}{c}" in k for f in fs for c in "(<"))
                    / 1e3, 4)
                for n, fs in kernel_names.items()}
        return {"wall_ms_profiled": wall_ms, "trace_span_ms": span_us / 1e3,
                "device_busy_ms": busy_us / 1e3,
                "device_busy_share": busy_us / span_us,
                "ported_kernels_ms": mine,
                "top_kernels_ms": [[k[:90], round(us / 1e3, 4), n]
                                   for us, k, n in rows[:top]]}

    # -- phase 6 ----------------------------------------------------------------
    def _layer_qkv(self):
        """The packed qkv of a shifted flagship Swin layer on the 512x512
        request (FeatMerge's feat_in layer 1: (1, 32, 32, 2304), 12 heads,
        2x2 windows) and its bias: position bias plus the -inf shift masks,
        (4, 256, 256)."""
        rt = self.rt
        wa = rt.model.prior_fusion.feat_in.block[1].attention_block
        got = {}
        hook = wa.to_qkv.register_forward_hook(
            lambda _m, _i, o: got.setdefault("qkv", o.detach().clone()))
        try:
            req = {f: v for f, v in self.requests["a_512x512"].items() if f != "y_hat"}
            rt.decode_only(**req, output="u8")
        finally:
            hook.remove()
        qkv = got["qkv"]
        ws = wa.window_size
        nwh, nww = qkv.shape[1] // ws, qkv.shape[2] // ws
        bias = (wa.pos_embedding.float()[None]
                + wa._shift_mask(nwh, nww, qkv.device)).contiguous()
        return qkv, bias, wa.heads, wa.head_dim ** -0.5

    @staticmethod
    def _to_gsd(qkv, heads, ws):
        """(B, H, W, 3C) packed qkv -> q, k, v (G = B * heads * nW, s, d),
        windows innermost, so window-head g takes bias[g % nW]."""
        B, H, W, c3 = qkv.shape
        d = c3 // 3 // heads
        nwh, nww = H // ws, W // ws
        t = qkv.reshape(B, nwh, ws, nww, ws, 3, heads, d).permute(
            5, 0, 6, 1, 3, 2, 4, 7).reshape(3, B * heads * nwh * nww, ws * ws, d)
        return [t[i].contiguous() for i in range(3)]

    @staticmethod
    def _from_gsd(out, B, H, W, heads, ws):
        """Inverse of :meth:`_to_gsd` for the output: (G, s, d) ->
        (B, H, W, heads * d)."""
        d = out.shape[-1]
        nwh, nww = H // ws, W // ws
        o = out.reshape(B, heads, nwh, nww, ws, ws, d)
        return o.permute(0, 2, 4, 3, 5, 1, 6).reshape(B, H, W, heads * d)

    def op(self):
        """Kernel 6's own path.  No model layer calls the (G, s, d) op, in
        the JAX package either; its entry point is the op itself, which
        this phase drives as bench.py's kernel_check drives the JAX one:
        forward and gradient at kernel_check's geometry, and on the (G, s,
        d) relayout of one flagship Swin layer's real qkv (with its -inf
        shift masks).  Then the layer's output against kernel 2's on the
        same qkv, and the layer shape against the plain version, timed."""
        torch = self.torch

        from sic_tpu_torch import ops
        g = torch.Generator(device="cuda").manual_seed(SEED + 6)
        bench = self._gsd_bench_inputs(g)
        qkv, bias, heads, scale = self._layer_qkv()
        B, H, W, _ = qkv.shape
        layer = (*self._to_gsd(qkv, heads, 16), bias)

        # -- the op's path: counts from 0, read right after ----------------------
        ops.reset_launch_counts()
        for inputs, sc in ((bench, 64 ** -0.5), (layer, scale)):
            self._gsd_grads(ops.window_attention, *inputs, sc)
        torch.cuda.synchronize()
        self.counts["op"] = counts = ops.launch_counts()
        # -------------------------------------------------------------------------

        out6 = ops.window_attention(*layer, scale)
        out2 = ops.window_attention_nhwc(qkv, bias, scale, heads)
        vs_k2 = (self._from_gsd(out6, B, H, W, heads, 16) - out2).abs().max().item()
        rec = {"layer": "prior_fusion.feat_in.block.1 (shifted), 512x512 request",
               "qkv_shape": list(qkv.shape), "heads": heads, "nW": bias.shape[0],
               "qkv_max_abs": qkv.abs().max().item(),
               "vs_window_attention_nhwc_max_abs_err": vs_k2,
               "vs_window_attention_nhwc_rel_err": vs_k2 / out2.abs().max().item(),
               "layer_check": self._gsd_check(*layer, scale),
               "launches": counts,
               "model_path_launches": {p: c.get("window_attention", 0)
                                       for p, c in self.counts.items() if p != "op"}}
        if counts["window_attention"] < 1 or \
                rec["vs_window_attention_nhwc_rel_err"] > GSD_FWD_TOL:
            raise AssertionError(f"window_attention op path: {rec}")
        return rec

    # -- phase 7 ----------------------------------------------------------------
    def serve(self):
        """The port's HTTP service in process on 127.0.0.1, flagship spec,
        seeded codec and CLIP, INDEX_DIR at phase 4's faiss/: compress and
        decompress, four concurrent requests of each against the serial
        answers, the three search streams, then the search and build CLIs
        on the card against their CPU runs."""
        import gc
        import os
        torch = self.torch

        from sic_tpu_torch.service import ServiceState, make_server
        env = {"INDEX_DIR": str(WORK / "encode_out" / "faiss"),
               "MEDIA_ROOT": str(WORK), "PREVIEW_CACHE": str(WORK / "previews")}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            state = ServiceState("flagship", device="cuda")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        allocated_gb = torch.cuda.memory_allocated() / 2 ** 30
        alive = self._alive()
        srv = make_server(state, host="127.0.0.1", port=0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            rec = self._serve_checks(state, f"http://127.0.0.1:{srv.server_address[1]}")
        finally:
            srv.shutdown()
            srv.server_close()
            th.join()
            state.close()
            del state, srv, th     # the server's handler class holds the state
            gc.collect()
            torch.cuda.empty_cache()
        # device memory held before the service and after it is gone, and
        # what is still alive then: runtimes and CLIP codecs besides phase
        # 4's, and the CUDA tensors' bytes
        rec["allocated_gb_before_after"] = [
            allocated_gb, torch.cuda.memory_allocated() / 2 ** 30]
        rec["alive_before_after"] = [alive, self._alive()]
        return rec

    def _alive(self):
        import gc

        from sic_tpu_torch.models.codec import CodecRuntime
        from sic_tpu_torch.retrieval.codec import ClipCodec
        torch = self.torch
        gc.collect()
        models, storages = [], {}
        for o in gc.get_objects():
            if isinstance(o, (CodecRuntime, ClipCodec)) and o is not self.rt:
                models.append(type(o).__name__)
            elif isinstance(o, torch.Tensor) and o.is_cuda:
                st = o.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
        return {"models": models, "cuda_tensor_gb": sum(storages.values()) / 2 ** 30}

    def _serve_checks(self, state, base):
        import concurrent.futures
        import contextlib
        import io
        import statistics

        import numpy as np
        torch = self.torch
        from PIL import Image

        from sic_tpu_torch import ops
        from sic_tpu_torch.cli.build import main as build_main
        from sic_tpu_torch.cli.search import main as search_main
        from sic_tpu_torch.container import sanitize_enc_result_types, unpack_c2df
        from sic_tpu_torch.data import load_image

        src = WORK / "encode_in"
        mosaic = (src / "a_512x512.png").read_bytes()
        vals = [(src / f"c_256x256_{i}.png").read_bytes() for i in range(4)]
        val3_c2df = (ROOT / "artifacts_r05" / "bitstreams" / "val3.c2df").read_bytes()
        val3_png = (HELDOUT / "val3.png").read_bytes()
        text = "a photo of a red apple on a table"
        r05 = ROOT / "artifacts_r05" / "faiss"

        def post(path, payload, name=None):
            if name is None:
                req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                             headers={"Content-Type": "application/json"})
            else:
                body, ctype = _multipart(name, payload)
                req = urllib.request.Request(base + path, data=body,
                                             headers={"Content-Type": ctype})
            with urllib.request.urlopen(req, timeout=600) as resp:
                return resp.read(), dict(resp.headers)

        def ndjson(raw):
            lines = [json.loads(ln) for ln in raw.decode().splitlines() if ln.strip()]
            kinds = [ln["type"] for ln in lines]
            ok = (kinds[0] == "meta" and lines[0]["stage"] == "start"
                  and kinds[1] == "meta" and lines[1]["stage"] == "searched"
                  and kinds[-1] == "done"
                  and kinds.count("item") == lines[1]["count"] == len(kinds) - 3)
            return [(ln["path"], ln["score"]) for ln in lines if ln["type"] == "item"], ok

        def cli_json(argv):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                search_main(argv)
            return [(r["path"], r["score"]) for r in json.loads(out.getvalue())]

        # warm-up (models loaded, cuBLAS/cuDNN handles), not counted
        t0 = time.perf_counter()
        _ = (state.runtime, state.clip)
        load_s = time.perf_counter() - t0
        c2df_w, _ = post("/compress", vals[0], "w.png")
        post("/decompress", c2df_w, "w.c2df")
        post("/search/stream/text", {"text": "warm-up"})

        # -- the serving path: counts from 0, read right after --------------------
        ops.reset_launch_counts()
        c2df_a, hdr = post("/compress", mosaic, "a_512x512.png")
        png_a, hdr_d = post("/decompress", c2df_a, "a_512x512.c2df")
        serial_c = [post("/compress", v, f"v{i}.png")[0] for i, v in enumerate(vals)]
        serial_d = [post("/decompress", c, f"v{i}.c2df")[0] for i, c in enumerate(serial_c)]
        # wide windows, so that the four concurrent requests form one group;
        # the default ones again afterwards, for the latencies below
        batchers = (state.enc_batcher, state.batcher)
        window_s = [b.window_s for b in batchers]
        before = [(b.batches_dispatched, b.requests_served) for b in batchers]
        for b in batchers:
            b.window_s = 0.5
        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
            conc_c = list(pool.map(lambda iv: post("/compress", iv[1], f"v{iv[0]}.png")[0],
                                   enumerate(vals)))
            conc_d = list(pool.map(lambda ic: post("/decompress", ic[1], f"v{ic[0]}.c2df")[0],
                                   enumerate(serial_c)))
        # [groups, requests] the concurrent requests took, per batcher
        groups = {name: [b.batches_dispatched - n0, b.requests_served - r0]
                  for name, b, (n0, r0) in zip(("encode", "decode"), batchers, before)}
        for b, w in zip(batchers, window_s):
            b.window_s = w
        search_c2df, ok_c = ndjson(post(f"/search/stream/c2df?topk=8&index_dir={r05}",
                                        val3_c2df, "val3.c2df")[0])
        search_img, ok_i = ndjson(post("/search/stream/image?topk=8", val3_png, "val3.png")[0])
        search_txt, ok_t = ndjson(post("/search/stream/text", {"text": text, "topk": 8})[0])

        def median_ms(fn, reps=5):
            times = []
            for _ in range(reps):
                t1 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t1) * 1e3)
            return statistics.median(times)

        latency = {
            "compress_512x512": median_ms(lambda: post("/compress", mosaic, "a.png")),
            "decompress_512x512": median_ms(lambda: post("/decompress", c2df_a, "a.c2df")),
            "compress_256x256": median_ms(lambda: post("/compress", vals[0], "v.png")),
            "decompress_256x256": median_ms(lambda: post("/decompress", serial_c[0], "v.c2df")),
            "search_c2df": median_ms(lambda: post(f"/search/stream/c2df?index_dir={r05}",
                                                  val3_c2df, "val3.c2df")),
            "search_image": median_ms(lambda: post("/search/stream/image", val3_png, "v.png")),
            "search_text": median_ms(lambda: post("/search/stream/text", {"text": text}))}
        torch.cuda.synchronize()
        self.counts["serve"] = counts = ops.launch_counts()
        # -------------------------------------------------------------------------

        # /compress then /decompress against the runtime on the same image
        rt = state.runtime
        enc, header = unpack_c2df(c2df_a)
        enc = sanitize_enc_result_types(enc)
        enc["z_coder"], enc["coding_batch"] = header["z_coder"], header["coding_batch"]
        dec = {}
        want = rt.decode_only(**enc, output="u8", probe=dec)[0].cpu().numpy()
        got = np.asarray(Image.open(io.BytesIO(png_a)))
        probe = {}
        x = torch.from_numpy(load_image(src / "a_512x512.png"))[None]
        ref = rt.encode_only(x, probe=probe)
        rec = {"load_s": round(load_s, 3),
               "compress_headers": {k: v for k, v in hdr.items() if k.startswith("X-SIC")},
               "decompress_headers": {k: v for k, v in hdr_d.items()
                                      if k.startswith("X-SIC")},
               "decompress_equals_decode_only": bool(np.array_equal(got, want)),
               "compress_equals_encode_only": ref["h_bit_stream"] == enc["h_bit_stream"]
               and ref["z_bit_stream"] == enc["z_bit_stream"],
               "h_hat_equal_y_hat": bool(torch.equal(dec["h_hat"], probe["y_hat"])),
               "concurrent_compress_equal_serial": conc_c == serial_c,
               "concurrent_decompress_equal_serial": conc_d == serial_d,
               "concurrent_groups": groups,
               "search_c2df_top3": search_c2df[:3],
               "ndjson_ok": [ok_c, ok_i, ok_t],
               "latency_ms_p50": latency, "launches": counts}

        # the search CLI over the same indexes, same queries, in this run.
        # query-image reads the file through [-1, 1] floats as the JAX CLI
        # does, the service takes the PIL image as the JAX one does; the two
        # differ only on pixel values 1-63, and val3's lie in 97-183
        idx4 = str(WORK / "encode_out" / "faiss")
        rec["search_image_equals_cli"] = search_img == cli_json(
            ["query-image", "--index_dir", idx4, "--image", str(HELDOUT / "val3.png"),
             "--topk", "8", "--device", "cuda"])
        rec["search_text_equals_cli"] = search_txt == cli_json(
            ["query-text", "--index_dir", idx4, "--text", text, "--topk", "8",
             "--device", "cuda"])
        qc = ["query-c2df", "--index_dir", str(r05), "--c2df",
              str(ROOT / "artifacts_r05" / "bitstreams" / "val3.c2df"), "--topk", "8"]
        card = cli_json(qc + ["--device", "cuda"])
        rec["query_c2df_card_equals_cpu"] = card == cli_json(qc + ["--device", "cpu"])
        rec["query_c2df_card_equals_service"] = card == search_c2df
        # the build CLI as a user runs it, and in process on the CPU
        bits = str(ROOT / "artifacts_r05" / "bitstreams")
        res = subprocess.run([sys.executable, "-m", "sic_tpu_torch.cli.build", "build",
                              "--c2df_dir", bits, "--index_dir", str(WORK / "build_card")],
                             cwd=ROOT, capture_output=True, text=True, timeout=300)
        with contextlib.redirect_stdout(io.StringIO()):
            build_main(["build", "--c2df_dir", bits, "--index_dir", str(WORK / "build_cpu")])
        rec["build_cli_rc"] = res.returncode
        rec["build_files_equal"] = res.returncode == 0 and all(
            (WORK / "build_card" / n).read_bytes() == (WORK / "build_cpu" / n).read_bytes()
            for n in ("faiss.index", "paths.json", "meta.json", "index.faiss", "ids.txt"))
        rec["profile_decompress_512x512"] = self._profile(
            lambda: post("/decompress", c2df_a, "a.c2df"))
        rec["search_wave_100k"] = wave = self._search_wave()

        top3 = [(Path(p).stem, s_) for p, s_ in search_c2df[:3]]
        top3_ok = [n for n, _ in top3] == [n for n, _ in R05_VAL3_TOP3] and all(
            abs(s_ - want_s) < 1e-4 for (_, s_), (_, want_s) in zip(top3, R05_VAL3_TOP3))
        need = ("seq_attention", "window_attention_nhwc", "rans_decode_plane")
        flags = ("decompress_equals_decode_only", "compress_equals_encode_only",
                 "h_hat_equal_y_hat", "concurrent_compress_equal_serial",
                 "concurrent_decompress_equal_serial", "search_image_equals_cli",
                 "search_text_equals_cli", "query_c2df_card_equals_cpu",
                 "query_c2df_card_equals_service", "build_files_equal")
        if not (all(rec[f] for f in flags) and all(rec["ndjson_ok"]) and top3_ok
                and all(n < 4 and r == 4 for n, r in groups.values())
                and rec["decompress_headers"].get("X-SIC-Stage") == "decompress"
                and len(search_img) == len(search_txt) == 8
                and min(counts[k] for k in need) >= 1
                and counts["window_attention"] == 0
                and wave["ids_equal_stable_sort"] and wave["scores_equal_stable_sort"]):
            raise AssertionError(f"serve check failed: {rec}")
        return rec

    def _search_wave(self, n=100_000, dim=512, nq=256, k=10, reps=5):
        """One search wave at the JAX package's documented search traffic
        (256 queries over 100k vectors, sic_tpu/retrieval/index.py:132):
        seeded unit vectors; the top k against a full stable sort of the
        same scores; the wave's time on the card (CUDA events, the query's
        upload included) beside the sort's, and through search() with the
        copy back (median of ``reps``); the database's bytes on the card."""
        import statistics

        import numpy as np
        torch = self.torch
        from sic_tpu_torch.retrieval import VectorIndex
        from sic_tpu_torch.retrieval.index import _round_bf16
        rng = np.random.default_rng(SEED + 7)
        index = VectorIndex(dim, device="cuda")
        index.add_batch(rng.standard_normal((n, dim), dtype=np.float32),
                        [str(i) for i in range(n)])
        q = rng.standard_normal((nq, dim), dtype=np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        db = index._db()
        s, i = index.search_device(q, k)

        def full_sort():
            scores = torch.matmul(_round_bf16(torch.from_numpy(q).cuda()), db.T).float()
            return torch.sort(scores, dim=-1, descending=True, stable=True)

        ref = full_sort()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            index.search(q, k)
            times.append((time.perf_counter() - t0) * 1e3)
        return {"n": n, "dim": dim, "queries": nq, "k": k,
                "db_gb": db.numel() * db.element_size() / 2 ** 30,
                "ids_equal_stable_sort": bool(torch.equal(i, ref.indices[:, :k])),
                "scores_equal_stable_sort": bool(torch.equal(s, ref.values[:, :k])),
                "search_device_ms": self.time_ms(lambda: index.search_device(q, k)),
                "full_sort_ms": self.time_ms(full_sort),
                "search_ms_p50": statistics.median(times)}

    # -- phase 8 ----------------------------------------------------------------
    def surface(self):
        """The codec's remaining user surface on the card: the evaluate CLI
        (seeded flagship), the concurrent runtime entry points on phase 4's
        runtime, reference-format (torchac) files, and --base_config /
        BASE_CONFIG on the CLIs, the service and the train CLI."""
        import gc
        torch = self.torch
        from sic_tpu_torch import ops

        parts, launches, ok = {}, {}, {}
        ops.reset_launch_counts()
        # -- the surface main path: counts from 0, read right after ------------
        for name, fn in (("evaluate", self._surface_evaluate),
                         ("concurrent", self._surface_concurrent),
                         ("torchac", self._surface_torchac),
                         ("base_config", self._surface_base_config)):
            before = ops.launch_counts()
            parts[name] = fn()
            ok[name] = parts[name].pop("ok")
            after = ops.launch_counts()
            launches[name] = {k: after[k] - before[k] for k in after}
            gc.collect()
            torch.cuda.empty_cache()
        self.counts["surface"] = counts = ops.launch_counts()
        # -----------------------------------------------------------------------
        rec = {**parts, "launches_by_part": launches, "launches": counts,
               "checks": ok}
        need = ("seq_attention", "window_attention_nhwc", "rans_decode_plane",
                "rans_encode_plane", "window_attention_nhwc_bwd")
        if not all(ok.values()) or min(counts[k] for k in need) < 1:
            raise AssertionError(f"surface check failed: {rec}")
        return rec

    def _surface_evaluate(self):
        """The evaluate CLI over the eight heldout images (seeded flagship,
        its own runtime): each record's bpps against the bytes of phase 4's
        runtime's encode_only of the image, its psnr against decode_only's
        output."""
        import io

        from sic_tpu_torch.cli.evaluate import main as evaluate_main
        from sic_tpu_torch.data import list_images, load_image
        from sic_tpu_torch.metrics import psnr
        torch = self.torch
        rt = self.rt
        out = io.StringIO()
        t0 = time.perf_counter()
        summary = evaluate_main(["--dataset_dir", str(HELDOUT), "--device", "cuda"],
                                out=out)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        records = [json.loads(ln) for ln in out.getvalue().splitlines()][:-1]
        diffs, bpp_equal = [], []
        for path, r in zip(list_images(HELDOUT), records):
            img = load_image(path)
            H, W = img.shape[:2]
            enc = rt.encode_only(img[None])
            z, h = len(enc["z_bit_stream"]) * 8, len(enc["h_bit_stream"]) * 8
            want = {"bpp": round((z + h + 48) / (H * W), 6),
                    "z_bpp": round(z / (H * W), 6), "h_bpp": round(h / (H * W), 6)}
            bpp_equal.append(all(r[k] == v for k, v in want.items())
                             and r["path"] == str(path))
            x_hat = rt.decode_only(**enc)
            ref = float(psnr(torch.from_numpy(img)[None].cuda(), x_hat)[0])
            diffs.append(abs(r["psnr"] - ref))
        return {"images": len(records), "evaluate_s": round(eval_s, 3),
                "s_per_image_incl_model_build": eval_s / max(len(records), 1),
                "summary": summary, "bpp_equal_encode_only": bpp_equal,
                "psnr_max_abs_diff_db": max(diffs),
                "ok": len(records) == 8 and all(bpp_equal) and max(diffs) <= 1e-4}

    def _surface_concurrent(self, reps=3):
        """decode_only_many (four workers) over phase 4's six streams
        against serial decode_only; round_trip_pipelined over three batches
        of four 256x256 images against the sequential batched pair;
        encode_decode_many over the eight heldout images against
        encode_decode.  All bit for bit; wall times (median of ``reps``,
        the two sides alternating) and one profiled call of each decode
        side."""
        import statistics

        import numpy as np

        from sic_tpu_torch.data import load_image
        torch = self.torch
        rt = self.rt
        reqs = [{f: v for f, v in e.items() if f != "y_hat"}
                for e in self.requests.values()]
        imgs = [load_image(HELDOUT / f"val{i}.png")[None] for i in range(8)]
        batches = [np.concatenate(imgs[0:4]), np.concatenate(imgs[4:8]),
                   np.concatenate(imgs[2:6])]

        def wall(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        sides = {
            "decode_serial": lambda: [rt.decode_only(**e) for e in reqs],
            "decode_many": lambda: rt.decode_only_many(reqs, workers=4),
            "round_trip_sequential": lambda: [
                rt.decode_only_batched(rt.encode_only_batched(b)) for b in batches],
            "round_trip_pipelined": lambda: rt.round_trip_pipelined(batches),
            "encode_decode_serial": lambda: [rt.encode_decode(x, x.shape[1:3])
                                             for x in imgs],
            "encode_decode_many": lambda: rt.encode_decode_many(imgs, workers=2)}
        outs, ms = {}, {k: [] for k in sides}
        for _ in range(reps):
            for k, fn in sides.items():
                outs[k], t = wall(fn)
                ms[k].append(t)
        eq = {
            "decode_only_many": all(torch.equal(a, b) for a, b in
                                    zip(outs["decode_many"], outs["decode_serial"])),
            "round_trip_pipelined": all(torch.equal(a, b) for a, b in zip(
                outs["round_trip_pipelined"], outs["round_trip_sequential"])),
            "encode_decode_many": all(
                torch.equal(a[0], b[0]) and a[1] == b[1]
                and a[2]["z_bit_stream"] == b[2]["z_bit_stream"]
                and a[2]["h_bit_stream"] == b[2]["h_bit_stream"]
                for a, b in zip(outs["encode_decode_many"],
                                outs["encode_decode_serial"]))}
        # where the threads' time goes: the device's busy share, serial
        # against four workers
        profiles = {k: self._profile(sides[k], top=4)
                    for k in ("decode_serial", "decode_many")}
        return {"streams": len(reqs), "batches": [list(b.shape) for b in batches],
                "wall_ms_median": {k: statistics.median(v) for k, v in ms.items()},
                "wall_ms": ms, "bit_equal": eq, "profiles": profiles,
                "ok": all(eq.values())}

    def _surface_torchac(self):
        """A flagship runtime writing torchac z streams (phase 4's model,
        the encode kernel forced) encodes the 512x512 mosaic through the
        compress CLI's compress_dir; its file with z_coder in the header
        and without it (as a reference file has it) decode through the
        decompress CLI's decompress_dir to the PNG bytes of phase 4's
        rans-format file of the same image."""
        from sic_tpu_torch.cli.compress import compress_dir
        from sic_tpu_torch.cli.decompress import decompress_dir
        from sic_tpu_torch.container import pack_c2df, unpack_c2df
        from sic_tpu_torch.models import CodecRuntime
        rt = self.rt
        root = WORK / "surface_torchac"
        shutil.rmtree(root, ignore_errors=True)
        (root / "in").mkdir(parents=True)
        shutil.copy(WORK / "encode_in" / "a_512x512.png", root / "in")
        trt = CodecRuntime(rt.spec, rt.model, stream_part=4,
                           device_entropy="device", z_format="torchac")
        try:
            compress_dir(trt, self.clip, root / "in", root / "out")
        finally:
            trt.close()
        files = {"torchac_key": root / "out" / "bitstreams" / "a_512x512.c2df",
                 "rans": WORK / "encode_out" / "bitstreams" / "a_512x512.c2df"}
        enc, header = unpack_c2df(files["torchac_key"])
        z_coder = header.pop("z_coder")
        files["torchac_no_key"] = root / "no_key" / "a_512x512.c2df"
        files["torchac_no_key"].parent.mkdir()
        files["torchac_no_key"].write_bytes(pack_c2df(enc, header))
        pngs = {}
        for name, f in files.items():
            d = root / f"dec_{name}"
            (d / "in").mkdir(parents=True)
            shutil.copy(f, d / "in")
            decompress_dir(rt, d / "in", d / "png", batch_size=1)
            pngs[name] = (d / "png" / "a_512x512.png").read_bytes()
        same = {k: pngs[k] == pngs["rans"] for k in ("torchac_key", "torchac_no_key")}
        return {"z_coder_written": z_coder,
                "z_bytes": {"torchac": len(enc["z_bit_stream"]),
                            "rans": len(unpack_c2df(files["rans"])[0]["z_bit_stream"])},
                "png_equal_rans_file": same,
                "ok": z_coder == "torchac" and all(same.values())}

    def _surface_base_config(self):
        """configs/config_small_r4.yaml (the repo's serving config, seeded):
        four heldout images through the compress and decompress CLIs on the
        card (one image a batch, as the service runs a lone request), then
        the service with BASE_CONFIG set: one /compress and one /decompress
        byte-equal to the CLIs' files; then the train CLI with
        tests/fixtures/config_tiny.yaml, one epoch a stage."""
        import os
        import warnings

        from sic_tpu_torch.cli.compress import main as compress_main
        from sic_tpu_torch.cli.decompress import main as decompress_main
        from sic_tpu_torch.cli.train import main as train_main
        from sic_tpu_torch.service import ServiceState, make_server
        torch = self.torch
        cfg = ROOT / "configs" / "config_small_r4.yaml"
        root = WORK / "surface_base_config"
        shutil.rmtree(root, ignore_errors=True)
        (root / "in").mkdir(parents=True)
        for i in range(4):
            shutil.copy(HELDOUT / f"val{i}.png", root / "in")
        common = ["--base_config", str(cfg), "--device", "cuda", "--batch_size", "1"]
        t0 = time.perf_counter()
        compress_main(["--dataset_dir", str(root / "in"), "--save_dir",
                       str(root / "c"), *common])
        n_dec = decompress_main(["--dataset_dir", str(root / "c" / "bitstreams"),
                                 "--save_dir", str(root / "d"), *common])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        env = {"BASE_CONFIG": str(cfg), "INDEX_DIR": str(root / "c" / "faiss"),
               "MEDIA_ROOT": str(root), "PREVIEW_CACHE": str(root / "previews")}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            state = ServiceState(device="cuda")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        srv = make_server(state, host="127.0.0.1", port=0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"

        def post(path, name, payload):
            body, ctype = _multipart(name, payload)
            req = urllib.request.Request(base + path, data=body,
                                         headers={"Content-Type": ctype})
            with urllib.request.urlopen(req, timeout=600) as resp:
                return resp.read()

        try:
            served_c2df = post("/compress", "val0.png",
                               (root / "in" / "val0.png").read_bytes())
            served_png = post("/decompress", "val0.c2df",
                              (root / "c" / "bitstreams" / "val0.c2df").read_bytes())
            spec_name = state.spec.titok.model_size
        finally:
            srv.shutdown()
            srv.server_close()
            th.join()
            state.close()
            del state, srv, th
        served = {"compress": served_c2df == (root / "c" / "bitstreams" / "val0.c2df").read_bytes(),
                  "decompress": served_png == (root / "d" / "val0.png").read_bytes()}
        t0 = time.perf_counter()
        with warnings.catch_warnings():   # uncalibrated LPIPS: no weights here
            warnings.simplefilter("ignore")
            train = train_main(["--base_config", str(ROOT / "tests" / "fixtures"
                                                     / "config_tiny.yaml"),
                                "--device", "cuda", "--train_dir", str(HELDOUT),
                                "--batch_size", "2",
                                "--ckpt_dir", str(TRAIN_WORK / "surface_ck")])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        return {"config": str(cfg.relative_to(ROOT)), "trunk": spec_name,
                "cli_files": n_dec, "cli_s": round(cli_s, 3),
                "service_equal_cli": served, "train_cli": train,
                "train_s": round(train_s, 3),
                "ok": (n_dec == 4 and spec_name == "small" and all(served.values())
                       and train["global_step"] == 12
                       and train["epoch_for_strategy"] == 3)}

    # -- phase 9 ----------------------------------------------------------------
    def train(self):
        """(a) the seeded flagship through create_train_state and Trainer
        at 256 px, batch 2: one epoch (four steps, then an eval step) of
        each stage; (b) the train CLI at the 512-px preset for one epoch,
        then one image compressed and decompressed with its params."""
        import dataclasses
        import gc
        import statistics
        import warnings
        torch = self.torch

        from sic_tpu_torch import ops
        from sic_tpu_torch.config import flagship_spec, qp_strategy
        from sic_tpu_torch.data import ImageDataset
        from sic_tpu_torch.train import Trainer, create_train_state
        from sic_tpu_torch.train.state import is_vqgan_decoder_side, named_codec_params
        spec = flagship_spec()
        base = qp_strategy(0, 256)
        strategy = dataclasses.replace(base, stages=tuple(
            dataclasses.replace(st, epoch_num=1) for st in base.stages))
        paths = [HELDOUT / f"val{i}.png" for i in range(8)]
        train_ds = ImageDataset(paths, 256, train=True)
        val_ds = ImageDataset(paths[:2], 256, train=False)
        shutil.rmtree(TRAIN_WORK, ignore_errors=True)

        # -- the training main path: counts from 0, read after (a) and (b) ---
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with warnings.catch_warnings():   # uncalibrated LPIPS: no weights here
            warnings.simplefilter("ignore")
            model, state, steps = create_train_state(spec, strategy, SEED, device="cuda")
        init_s = time.perf_counter() - t0
        pix_step = steps.pix_step
        step_ms = {}

        def timed(fn):
            def run(st, x, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(st, x, **kw)
                torch.cuda.synchronize()
                stage = strategy.stage_at(st.epoch_for_strategy)[0]
                step_ms.setdefault(stage, []).append((time.perf_counter() - t) * 1e3)
                return out
            return run

        steps.feat_step, steps.pix_step = timed(steps.feat_step), timed(steps.pix_step)
        logs = []
        trainer = Trainer(model, state, steps, strategy, log_fn=logs.append, log_every=1)
        named = named_codec_params(model)
        frozen0 = {k: p.detach().clone() for k, p in named if not p.requires_grad}
        train0 = {k: p.detach().clone() for k, p in state.trainable}
        disc0 = [p.detach().clone() for p in state.disc.parameters()]

        def moved(keys):
            return sum(not torch.equal(dict(state.trainable)[k], train0[k]) for k in keys)

        decoder_side = [k for k in train0 if is_vqgan_decoder_side(k)]
        rest = [k for k in train0 if not is_vqgan_decoder_side(k)]
        for _ in range(2):                # feat_wo_bpp, feat
            trainer.fit(lambda: train_ds.batches(2, epoch=state.epoch_for_strategy),
                        lambda: val_ds.batches(2, shuffle=False), epochs=1)
        after_feat = {"decoder_side_moved": moved(decoder_side),
                      "other_trainable_moved": moved(rest)}
        trainer.fit(lambda: train_ds.batches(2, epoch=state.epoch_for_strategy),
                    lambda: val_ds.batches(2, shuffle=False), epochs=1)       # pix
        after_pix = {"decoder_side_moved": moved(decoder_side),
                     "other_trainable_moved": moved(rest)}
        frozen_equal = all(torch.equal(p, frozen0[k]) for k, p in named if k in frozen0)
        n_frozen = len(frozen0)
        disc_moved = sum(not torch.equal(a, b) for a, b in
                         zip(state.disc.parameters(), disc0))
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        numbers = [v for d in logs for v in d.values() if isinstance(v, float)]
        finite = all(v == v and abs(v) != float("inf") for v in numbers)
        stages_run = sorted({d["stage"] for d in logs if "stage" in d and "epoch" in d})
        x = torch.as_tensor(next(train_ds.batches(2, epoch=0)), device="cuda")
        profile = self._profile(lambda: pix_step(state, x))
        del model, state, steps, trainer, frozen0, train0, disc0, named
        gc.collect()
        torch.cuda.empty_cache()
        cli = self._train_cli()
        self.counts["train"] = counts = ops.launch_counts()
        # ----------------------------------------------------------------------
        rec = {"spec": "flagship", "dtype": "float32", "init_s": round(init_s, 3),
               "stages_run": stages_run, "steps": {k: len(v) for k, v in step_ms.items()},
               "step_ms_median": {k: statistics.median(v) for k, v in step_ms.items()},
               "step_ms": step_ms, "losses_finite": finite, "log_lines": len(logs),
               "last_logs": logs[-2:], "frozen_leaves": n_frozen,
               "frozen_bit_unchanged": frozen_equal,
               "trainable_leaves": {"decoder_side": len(decoder_side), "other": len(rest)},
               "after_feat_stages": after_feat, "after_pix": after_pix,
               "disc_leaves_moved": disc_moved, "peak_mem_gb": peak_gb,
               "profile_pix_step": profile, "cli_512px": cli, "launches": counts}
        need = ("seq_attention", "window_attention_nhwc", "window_attention_nhwc_bwd")
        ok = (finite and frozen_equal and stages_run == ["feat", "feat_wo_bpp", "pix"]
              and after_feat["decoder_side_moved"] == 0
              and after_feat["other_trainable_moved"] >= 0.9 * len(rest)
              and after_pix["decoder_side_moved"] >= 0.9 * len(decoder_side)
              and disc_moved > 0 and min(counts[k] for k in need) >= 1
              and cli["ok"])
        if not ok:
            raise AssertionError(f"training check failed: {rec}")
        return rec

    def _train_cli(self):
        """The train CLI at the 512-px preset (qp 0: straight into pix),
        one epoch over the heldout images with validation; then one
        512x512 image through the compress and decompress CLIs with its
        deploy_params.npz, and h_hat against the encoder's y_hat."""
        import gc
        torch = self.torch

        from sic_tpu_torch.cli._common import load_runtime
        from sic_tpu_torch.cli.compress import main as compress_main
        from sic_tpu_torch.cli.decompress import main as decompress_main
        from sic_tpu_torch.cli.train import main as train_main
        from sic_tpu_torch.config import flagship_spec
        from sic_tpu_torch.data import load_image
        ckpt = TRAIN_WORK / "ckpt"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = train_main(["--qp", "0", "--train_px", "512", "--epochs", "1",
                          "--batch_size", "2", "--train_dir", str(HELDOUT),
                          "--val_dir", str(HELDOUT), "--ckpt_dir", str(ckpt),
                          "--device", "cuda"])
        torch.cuda.synchronize()
        rec = {"train_s": round(time.perf_counter() - t0, 3), "result": out,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
               "files": sorted(p.name for p in ckpt.iterdir()),
               "last_bytes": (ckpt / "last").stat().st_size}
        gc.collect()
        torch.cuda.empty_cache()
        deploy = ckpt / "deploy_params.npz"
        src = TRAIN_WORK / "one"
        src.mkdir(parents=True, exist_ok=True)
        shutil.copy(WORK / "encode_in" / "a_512x512.png", src / "a_512x512.png")
        t0 = time.perf_counter()
        compress_main(["--dataset_dir", str(src), "--save_dir", str(TRAIN_WORK / "c"),
                       "--ckpt_path", str(deploy), "--spec", "flagship", "--device", "cuda"])
        n_dec = decompress_main(["--dataset_dir", str(TRAIN_WORK / "c" / "bitstreams"),
                                 "--save_dir", str(TRAIN_WORK / "d"), "--ckpt_path",
                                 str(deploy), "--spec", "flagship", "--device", "cuda"])
        rec["cli_round_trip_s"] = round(time.perf_counter() - t0, 3)
        rt = load_runtime(str(deploy), flagship_spec(), device="cuda", stream_part=4)
        probe, dec = {}, {}
        enc = rt.encode_only(load_image(src / "a_512x512.png")[None], probe=probe)
        rt.decode_only(**enc, coding_batch=8, probe=dec)
        rt.close()
        rec["h_hat_equal_y_hat"] = bool(torch.equal(dec["h_hat"], probe["y_hat"]))
        rec["decoded_files"] = n_dec
        rec["ok"] = (out["global_step"] == 4 and "last" in rec["files"]
                     and "deploy_params.npz" in rec["files"] and n_dec == 1
                     and rec["h_hat_equal_y_hat"])
        del rt
        gc.collect()
        torch.cuda.empty_cache()
        return rec

    # -- phase 10 ---------------------------------------------------------------
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
        rec["train_step"] = train = self._train_cpu_compare()
        if mism or sym_mism or not max_diff <= CPU_PIXEL_TOL or not train["ok"]:
            raise AssertionError(f"card vs CPU: {rec}")
        return rec

    def _train_cpu_compare(self):
        """One tiny-spec feat step and one pix step, each from the same
        fresh weights, batch and noise on the card and on the CPU (the
        bottleneck at O(1) weights, as trained weights keep it, so that no
        rounding of the straight-through quantizer sits on a float's last
        bit).  The pix step is held to ``PIX_LOSS_TOL`` and
        ``PIX_GRAD_TOL``; the same steps on the CPU with one thread instead
        of all (another summation order on one device) are reported as the
        witness of how far f32 order alone moves them."""
        import dataclasses
        import warnings

        import numpy as np
        torch = self.torch
        from sic_tpu_torch.config import qp_strategy, tiny_spec
        from sic_tpu_torch.data import ImageDataset
        from sic_tpu_torch.train import create_train_state
        from sic_tpu_torch.weights import export_flax_params
        base = qp_strategy(0, 256)
        strategy = dataclasses.replace(base, stages=tuple(
            dataclasses.replace(st, epoch_num=1) for st in base.stages))

        def fresh():
            """(cpu, card, cpu again) states with the same weights."""
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                _, cpu, steps = create_train_state(tiny_spec(), strategy, SEED,
                                                   device="cpu")
                rng = np.random.default_rng(SEED)
                with torch.no_grad():
                    for p in cpu.model.hybrid_codec.quantize_feat.parameters():
                        fan_in = p[0].numel() if p.dim() > 1 else p.numel()
                        scale = 0.05 if p.dim() == 1 else 0.5 * fan_in ** -0.5
                        gain = 1.0 if p.dim() == 2 and p.shape[0] == 1 else 0.0
                        p.copy_(torch.from_numpy(
                            gain + scale * rng.standard_normal(p.shape).astype(np.float32)))
                out = {"cpu": cpu}
                for name, dev in (("card", "cuda"), ("cpu_1_thread", "cpu")):
                    _, st, _ = create_train_state(tiny_spec(), strategy, SEED, device=dev,
                                                  codec_params=export_flax_params(cpu.model))
                    st.disc.load_state_dict(cpu.disc.state_dict())
                    st.lpips.load_state_dict(cpu.lpips.state_dict())
                    out[name] = st
            return out, steps

        def diff(logs, grads, a, b):
            loss = max(abs(float(logs[a][k]) - float(v)) / max(abs(float(v)), 1e-12)
                       for k, v in logs[b].items() if abs(float(v)) > 1e-6)
            floor = 1e-6 * float(torch.sqrt(sum((g * g).sum() for _, g in grads[b])))
            leaf = max((float((ga - gb).norm()) - floor) / max(float(gb.norm()), 1e-30)
                       for (_, gb), (_, ga) in zip(grads[b], grads[a]))
            return loss, leaf

        x = next(ImageDataset([HELDOUT / f"val{i}.png" for i in range(2)], 256,
                              train=False).batches(2))
        noise = torch.rand((2, 8, 8, 16), generator=torch.Generator().manual_seed(SEED)) - 0.5
        threads = torch.get_num_threads()
        rec = {}
        for name in ("feat_step", "pix_step"):
            states, steps = fresh()
            logs = {}
            for dev, st in states.items():
                torch.set_num_threads(1 if dev == "cpu_1_thread" else threads)
                try:
                    logs[dev] = getattr(steps, name)(st, torch.as_tensor(x, device=st.device),
                                                     noise=noise.to(st.device))
                finally:
                    torch.set_num_threads(threads)
            grads = {dev: [(path, p.grad.double().cpu()) for path, p in st.trainable]
                     for dev, st in states.items()}
            card = diff(logs, grads, "card", "cpu")
            spread = diff(logs, grads, "cpu_1_thread", "cpu")
            rec[name] = {"max_loss_rel_err": card[0], "max_leaf_grad_rel_err": card[1],
                         "cpu_spread_loss": spread[0], "cpu_spread_leaf_grad": spread[1],
                         "leaves": len(grads["cpu"])}
        feat, pix = rec["feat_step"], rec["pix_step"]
        rec["ok"] = (feat["max_loss_rel_err"] <= TRAIN_LOSS_TOL
                     and feat["max_leaf_grad_rel_err"] <= TRAIN_GRAD_TOL
                     and pix["max_loss_rel_err"] <= PIX_LOSS_TOL
                     and pix["max_leaf_grad_rel_err"] <= PIX_GRAD_TOL)
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
                 "window_attention_nhwc_bwd": ("sic_tpu_torch/csrc/window_attention_bwd.cu",
                                               "sic_tpu/ops/window_attention.py:231"),
                 "rans_decode_plane": ("sic_tpu_torch/csrc/rans_decode.cu",
                                       "sic_tpu/ops/rans_decode.py:165"),
                 "rans_encode_plane": ("sic_tpu_torch/csrc/rans_encode.cu",
                                       "sic_tpu/ops/rans_encode.py:77"),
                 "window_attention": ("sic_tpu_torch/csrc/window_attention_gsd.cu",
                                      "sic_tpu/ops/window_attention.py:27")}
        rows = []
        for name, (source, replaces) in names.items():
            k = self.kernels.get(name, {})
            # launches over the main-path runs (encode, decode, the
            # (G, s, d) op, serving, training)
            launches = sum(c.get(name, 0) for c in self.counts.values())
            rows.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "launches": launches,
                         "max_abs_err": k.get("max_abs_err"), "ms": k.get("ms"),
                         "plain_ms": k.get("plain_ms"), "bound_ms": k.get("bound_ms"),
                         "bound_by": k.get("bound_by"),
                         "tc_bound_ms": k.get("tc_bound_ms"),
                         "chain_bound_ms": k.get("chain_bound_ms"),
                         "device_ms": k.get("device_ms"),
                         "library_device_ms": k.get("library_device_ms"),
                         "deterministic": k.get("deterministic"),
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
        smoke.phase("op", smoke.op)
        smoke.phase("serve", smoke.serve)
        smoke.phase("surface", smoke.surface)
        smoke.phase("train", smoke.train)
    if not {"encode", "flagship"} & set(smoke.failed):
        smoke.phase("cpu", smoke.cpu_compare)
    if getattr(smoke, "rt", None) is not None:
        smoke.rt.close()
    shutil.rmtree(TRAIN_WORK, ignore_errors=True)
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
