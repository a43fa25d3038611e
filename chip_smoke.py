#!/usr/bin/env python3
"""Chip check of the PyTorch port on one CUDA card: encode, decode, the
(G, s, d) window-attention op, the HTTP service with search, the evaluate
CLI, the concurrent runtime entry points, reference-format files and YAML
configs, bf16 serving, int8 W8A8 serving, training, bf16 training, TiTok
tokenization with MaskGIT generation, two ranks compressing and training
across processes on the one card, and two ranks training and encoding
under the mesh shardings (FSDP, tensor parallelism, the width split).

    python3 chip_smoke.py          # from the repository root, one card
    python3 chip_smoke.py --phases kernels,mesh   # the build and those alone

Phases, each printing one JSON line with the card's name and power limit:

1. build    - the seven CUDA kernels (one nvcc per source, in parallel) and
              the native rANS coder, from the sources in the checkout; the
              HGMMA (wgmma) count of each kernel function of the four
              attention libraries (kernels 1, 2, 5 and 6; split TF32, and
              the bf16 entries of 1, 2 and 6), which must be above 0 in
              every one but kernel 5's dbias pass, bf16 HGMMA only in the
              bf16 entries (kernels 1, 2, 5 and 6) and none
              in the f32 ones; a dependent-chain probe
              (csrc/chain_probe.cu) reads the least latency of one step of
              each rANS chain in SM cycles, and nvidia-smi the SM's highest
              clock, for the rANS rows' chain bound;
2. kernels  - each kernel against its plain PyTorch version on the card at
              the flagship's shapes (kernel 1 also at the MaskGIT
              generator's, head dim 48, the tiny generator's, head dim
              32, and TiTok-S-128's U-ViT generator's and TiTok-S
              decoder's, S 129 and 385, in both entries; rANS decode also against the native
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
              on the f32 cores and, as split TF32, on the tensor cores;
              the bf16 entries of kernels 1, 2 and 6 at the f32 rows'
              shapes, each within 1.5x the plain bf16 version's error
              against f64, SDPA in bf16 as their yardstick, their bound on
              the bf16 tensor cores and in bytes at 2 bytes an element;
              kernel 5's bf16 entry at the two training shapes, dqkv within
              1.5x the plain bf16 version's error against f64, dbias within
              BWD_TOL of the plain version's, SDPA's bf16 autograd backward
              as its yardstick, its four passes' device times
              (passes_device_ms); every bf16 row's device time over SDPA's
              in the same run (vs_library);
              each rANS row's bytes bound and chain bound (the longest
              substream's coded symbols times the probe's step), and its
              error against an f64 reference; every attention kernel
              launched twice on one input must give the same bits; the
              fused GroupNorm (+ SiLU) at the pixel decoders' shapes
              (GN_SHAPES) within GN_TOL of its plain version, twice to the
              same bits, beside PyTorch's composite ops that the port ran
              before it (timed only), with its two-pass and one-pass bytes
              bounds;
3. golden   - the JAX-encoded tests/fixtures/golden stream through the CLI
              (host coder) and through the rANS decode kernel, against the
              committed pixels; then golden_input() encoded on the card by
              the host coder and by the encode kernel, byte-equal, decoding
              back bit for bit, and compared (not asserted) with
              golden.c2df;
4. encode   - seeded flagship model (TiTok-L, fp32) and seeded CLIP
              ViT-B/32 on real images (artifacts_r05/heldout: eight 256x256,
              a 512x512 mosaic, a 256x768 strip): the compress CLI over the
              ten, the host coder's fan-out over the eight 256x256 images'
              packed planes at workers 1 and 8 (byte-equal, timed),
              encode_only / encode_only_batched with the encode kernel
              and with the host coder (byte-equal), every stream decoding
              back to the encoder's y_hat bit for bit, times and a profile;
5. flagship - decode_only / decode_only_batched / the decompress CLI on
              streams from phase 4 (one 512x512, one 256x768, four
              256x256), every h_hat equal to the encoder's y_hat; the
              pixel decoder and the encoder at 4 and 8 x 256x256 run
              batched and one stream at a time, timed A B B A, and the
              outputs of the two compared (batch invariance); one
              decode_only and one encode_only with timer=StageTimer(),
              recording the JAX runtime's stage names; the four 256x256
              streams' batched host decode at workers 1 and 8 (the same
              y_hat, timed);
6. op       - the (G, s, d) window-attention op, forward and gradient, at
              kernel_check's geometry and on one flagship Swin layer's real
              qkv (FeatMerge's shifted feat_in layer on the 512x512
              request, -inf masks included), in f32 and through the bf16
              entry, whose output must agree with kernel 2's on the same
              qkv within GSD_FWD_TOL in both dtypes (one tensor-core body,
              two geometries);
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
9. bf16     - the bf16 serving mode at flagship width through the
              defaults (load_runtime, the compress and decompress CLIs and
              the service with no dtype: bf16 on CUDA): encode_only and
              encode_only_batched of phase 4's images, each stream decoding
              to its encoder's y_hat bit for bit through the bf16 and the
              fp32 runtime; decode_only / decode_only_batched of phase 5's
              streams, h_hat equal to y_hat, pixels against the fp32
              runtime's within 2x the JAX package's own bf16-vs-fp32 gap
              on golden.c2df (tests/fixtures/golden_bf16.py); one served
              /compress and /decompress; request times of bf16 beside
              fp32 (median of 5) and one profiled bf16 decode;
10. int8    - the W8A8 int8 serving mode at flagship width through
              load_runtime(quant="int8"), in fp32 and in bf16:
              encode_only of the 512x512 image and encode_only_batched of
              the eight 256x256 (the encode kernel's coder), decode_only of
              phase 5's 512x512 stream and decode_only_batched of the eight
              int8 streams, the compress and decompress CLIs with --quant
              int8, one served /compress and /decompress under
              SIC_QUANT=int8; every int8 stream decoding to its encoder's
              y_hat in the fp32, bf16 and both int8 runtimes; every Linear
              left float one of the two sensitive layers (no float
              fallback); int8 GEMM launches and kernels 1-4 launched; the
              int8-vs-fp32 pixel gap reported (relative norm below the JAX
              package's cascade bound, 0.3); request times of the four
              modes, one profiled int8 decode, and the int8 GEMM
              (torch._int_mm, cuBLASLt) at the flagship's Linear shapes
              against bf16 and fp32 F.linear, with its bounds at 1,979
              int8 TOPS, 989 bf16 TFLOP/s, 67 f32 TFLOP/s and 3.35 TB/s;
11. train   - the seeded flagship trained through create_train_state and
              Trainer at 256 px, batch 2, on the heldout images: four steps
              of each stage (feat_wo_bpp, feat, pix) and an eval step after
              each, every loss finite, frozen leaves bit-unchanged,
              trainable leaves moved, the VQGAN decoder side unchanged
              after the feat stages and moved after pix, the discriminator
              moved; then the train CLI at the 512-px preset (starts in
              pix; TiTok-L's trunks at CLI_TRUNK_LAYERS of their 24 layers,
              full width, as every train CLI and its round trip below) for
              one epoch, its `last` checkpoint and
              deploy_params.npz, and one image compressed and decompressed
              with those params, h_hat equal to the encoder's y_hat; step
              times, peak memory and one profiled pix step (the CLI with
              its CUDA defaults: bf16 Adam moments and frozen storage);
12. train_bf16 - the same Trainer run with create_train_state(dtype,
              mu_dtype, frozen_dtype all bf16): every loss finite, frozen
              leaves bf16 and bit-unchanged, trainable leaves f32 and
              moved, the VQGAN decoder side unchanged after the feat
              stages, Adam's mu bf16, bf16 launches of kernels 1, 2 and 5;
              step medians and peak memory beside phase train's; one pix
              step with remat against the same step without from one
              snapshot and noise (equal, or no farther apart than two runs
              without), each one's peak memory; the train CLI's CUDA
              defaults on tests/fixtures/config_tiny.yaml for one epoch
              with --log_dir (an event file and scalars.jsonl);
13. generate - TiTok 1-D tokenization and MaskGIT generation at full
              width, seeded: TiTok-L (tile 256) with the MaskGIT-VQGAN
              pixel decoder and the MaskGIT generator (hidden 768, 16
              heads: head dim 48); generate of four classes (8 steps,
              guidance 3.0) twice from one seed (ids equal, in vocabulary,
              no mask id), decode_tokens of those ids, TiTok.forward on the
              eight heldout images, forward_latent_concat on the 512x512
              mosaic and the generate CLI (four PNGs); kernel 1 launched at
              head dims 48 and 64; times (median of 5) and a profile of
              generate and of decode_tokens; one generator
              forward and one decode_tokens against CPU copies (within
              GENERATE_CPU_TOL of the largest magnitude), and the ids a
              temperature-0 sampling differs in, card against CPU
              (reported);
14. cpu     - the first 256x256 request decoded again on the CPU (plain
              versions): CDF-index planes and pixels against the card's;
              one 256x256 image encoded on the CPU, its differences from
              the card's encode reported; and one tiny-spec feat step and
              pix step on the card against the CPU (losses within 1e-4
              relative, each leaf's gradient within 1e-3 of its norm; the
              pix step within 1e-3 and 5e-3, its adaptive weight being
              ill-conditioned in f32), the CPU's own spread (one thread
              against all) reported beside them;
15. multiprocess - two ranks on the one card (gloo), each this script
              re-invoked as ``--rank-task compress|train <record.json>``
              with WORLD_SIZE, RANK, MASTER_ADDR and MASTER_PORT: the
              compress CLI at world size 2 over val0..7 at batch 2, every
              stream and the merged index equal to a one-process
              compress_dir's; one feat and one pix step of the seeded
              flagship at 256 px, global batch 2, data-parallel (one image
              a rank) and as a two-stage pipeline (two microbatches), then
              the one-process steps in rank 0 (rank 1 idle) as they run
              ("global") and with every Linear and convolution on the
              ranks' halves of the batch ("split"): data parallelism within
              the card-vs-CPU training bounds of "split", the pipeline of
              "global", every other distance reported (cuBLAS and cuDNN
              sum otherwise at batch 1 than at 2); the train CLI with --pp 2
              --pp_microbatch 2 at 256 px (the qp 0 preset cut to one feat
              and one pix epoch, trunks at CLI_TRUNK_LAYERS), its
              deploy_params.npz through the compress and decompress CLIs,
              h_hat against y_hat; step times and peak memory a rank.
16. mesh    - the JAX package's mesh shardings across processes, two ranks
              on the one card (gloo), each this script (--rank-task mesh):
              a feat and a pix step of the seeded flagship at 256 px,
              global batch 2, under --fsdp equal to the data-parallel step
              bit for bit (each rank's bytes at rest: the DP rank's less
              one chunk of every planned leaf); the same steps at --tp 2
              and at --tile 2 (val0 and val1 side by side, 1 x 256 x 512)
              against rank 0's one-process step run with the ranks' shapes
              ("split": the TP-split Linears as the ranks' blocks, the
              convolutions, pointwise Linears and GroupNorms as the ranks'
              slabs) within PERF.md §2's bounds, and against the step as it
              runs within the larger of those bounds and 1.5x "split"'s own
              gap; CodecRuntime(mesh=) at tile 2 over val0 and val1, its
              streams decoding in a one-process runtime to its y_hat bit
              for bit; the train CLI with --tp 2 and with --fsdp (the qp 0
              preset cut to one feat and one pix epoch, trunks at
              CLI_TRUNK_LAYERS), each one's deploy_params.npz through the
              compress and decompress CLIs.
              Kernels 1, 2 and 5 must launch in every rank of the TP and
              tile runs, kernel 1 at 8 and 6 local heads, kernels 2 and 5
              at 6 and 8.

Each path's launch counts are set to 0 just before it is driven (phase 4
for the encode, phase 5 for the decode, phase 6 for the op, phase 7 for
serving, phase 8 for the surface, phase 9 for bf16 serving, phase 10 for
int8 serving, phase 11 for training, phase 12 for bf16 training, phase 13
for generation, each rank of phase 15 at its start, each rank of phase 16
around each of its sharded runs) and read just after (phases 15 and 16: by
each rank, summed over the ranks), by wrapper, by bf16 entry and (kernel
1) by head dim (phase 16 also by head count), and phase 10's int8 GEMMs
apart, and the GroupNorm kernel's launches and composite calls apart;
every kernel of the path must have launched, the (G, s, d) kernel on no
model path, and every GroupNorm of phases 5, 7, 9 and 13 (inference) in
the kernel (composite 0).
Every phase but 9, 10 and 12 runs fp32 and asks for it (the train CLI's
moments and frozen storage aside).  Then a ``{"kernels":
[...]}`` line (the bf16 entries as rows of their own), the nvidia-smi
line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
without a CUDA device, outside the repository, or if any phase fails.
Work files go to ``WORK`` below.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
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
MP_WORK = WORK / "multiprocess"      # the multiprocess phase's files and rank logs
MESH_WORK = WORK / "mesh"            # the mesh phase's
# the train CLIs (phases train, multiprocess and mesh) and their deploy
# round trips: TiTok-L's trunks at this depth, their widths whole (two cells
# of four layers: --pp 2 still has a stage a cell); the steps and the
# sharded steps run the whole flagship
CLI_TRUNK_LAYERS = 8
GOLDEN = ROOT / "tests" / "fixtures" / "golden"
HELDOUT = ROOT / "artifacts_r05" / "heldout"

F32_TFLOPS = 67e12      # H100 SXM f32 outside the tensor cores
TF32_TFLOPS = 495e12    # H100 SXM dense TF32 on the tensor cores
BF16_TFLOPS = 989e12    # H100 SXM dense bf16 on the tensor cores
INT8_TOPS = 1979e12     # H100 SXM dense int8 on the tensor cores
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
# a bf16 entry's error against the f64 function, as a multiple of the plain
# bf16 version's error against it
BF16_F64_RATIO = 1.5
# the (G, s, d) window-attention kernel vs its plain version: the forward
# within this share of the output's largest magnitude, each gradient (q, k,
# v, bias) within GSD_GRAD_TOL of its own largest magnitude; f32 summation
# order only
GSD_FWD_TOL = 1e-5
GSD_GRAD_TOL = 1e-4
# the fused GroupNorm (+ SiLU) vs its plain version, as a share of the
# output's largest magnitude (f32 sums of groups of up to 4 M elements in
# another order; the kernel's SiLU takes the hardware's exp2); a bf16
# output may differ by one ulp more, where that gap moves the rounding
GN_TOL = 1e-5
# its shapes, (B, H, W, C), dtype, SiLU: the flagship pixel decoder in bf16
# at 512x512 and at its attention blocks' 32x32, MaskGIT-VQGAN's in f32
GN_SHAPES = {"flagship_512px_bf16": ((8, 512, 512, 128), "bfloat16", True),
             "flagship_32px_attn_bf16": ((8, 32, 32, 512), "bfloat16", False),
             "maskgit_256px_f32": ((16, 256, 256, 128), "float32", True)}
# the JAX CLI's three best scores for val3.c2df over artifacts_r05/faiss
R05_VAL3_TOP3 = (("val3", 0.99724), ("val4", 0.99316), ("val6", 0.99262))
SEED = 0
# kernel 1's shapes, (B, S, C, heads): the ViT trunk (four 256-px tiles),
# the cross blocks and the CLIP image tower at head dim 64; the MaskGIT
# generator at full width (head dim 48) at the generate phase's batch of
# four classes, and the generate CLI's tiny one (head dim 32)
SEQ_SHAPES = {"trunk": (4, 289, 1024, 16), "cross": (4, 545, 768, 12),
              "clip": (1, 50, 768, 12), "maskgit": (4, 33, 768, 16),
              "tiny_generator": (2, 9, 64, 2), "uvit": (16, 129, 1024, 16),
              "titok_s_decoder": (16, 385, 512, 8)}
# TiTok-S-128's rows (the U-ViT generator and TiTok-S's decoder at the
# benchmark's batch of 16) draw from a generator of their own, so that
# every other row's inputs stay as they were
S128_SEQ_SHAPES = ("uvit", "titok_s_decoder")
# a --tp 2 rank's: the trunk's and the cross blocks' local heads (8, 6);
# kernel 2's rows at 6 and 8 local heads are in the kernels phase's loop
TP_SEQ_SHAPES = {"trunk_tp2": (4, 289, 512, 8), "cross_tp2": (4, 545, 384, 6)}
# card vs CPU, the full-width MaskGIT generator's logits and TiTok's
# decode_tokens pixels, relative to their largest magnitude (f32
# summation order only)
GENERATE_CPU_TOL = 1e-3


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
        self.bf16_counts = {}  # path -> launches of the bf16 entries in that run
        self.head_dim_counts = {}  # path -> kernel 1's launches by head dim
        self.heads_counts = {}     # path -> the packed-qkv kernels' launches by head count
        self.gn_counts = {}   # path -> the GroupNorm kernel's launches and composite calls
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
    def read_counts(self, path):
        """The launch counts of ``path``'s main-path run, read right after
        it: by wrapper, and the bf16 entries' apart."""
        from sic_tpu_torch import ops
        self.bf16_counts[path] = ops.bf16_launch_counts()
        self.head_dim_counts[path] = ops.head_dim_launch_counts()
        self.gn_counts[path] = ops.group_norm_counts()
        self.counts[path] = ops.launch_counts()
        return self.counts[path]

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
                # "void (anonymous namespace)::bwd_stats_kernel<float, 2>(...)"
                # -> "bwd_stats_kernel<float, 2>"
                key = e.name.replace("(anonymous namespace)::", "").split("(")[0]
                key = key.removeprefix("void ").split("::")[-1][:60]
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
    def bf16_bound(flops, nbytes):
        """Least time of a bf16 entry, ms, and what bounds it: its products
        on the bf16 tensor cores against the bytes it moves once (2 bytes
        an operand element, 4 a bias element)."""
        t_ops, t_bytes = flops / BF16_TFLOPS, nbytes / HBM_BYTES_S
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
        reports = cuda_build.build(cuda_build.KERNELS + ("chain_probe",))
        th.join()
        if "error" in native:
            raise native["error"]
        regs = {n: [ln.strip() for ln in r.splitlines()
                    if "registers" in ln or "spill" in ln or "entry function" in ln]
                for n, r in reports.items()}
        for n in cuda_build.KERNELS:
            cuda_build.load(n)
        # the attention kernels (1, 2, 5 and 6) run on the tensor cores: every
        # kernel function (entry and warpgroup count) holds wgmma but kernel
        # 5's dbias pass (a sum over the batch on the CUDA cores), the bf16
        # entries' bf16 wgmma only, the f32 entries' none
        hgmma = {n: cuda_build.sass_hgmma(n) for n in (
            "seq_attention", "window_attention", "window_attention_bwd",
            "window_attention_gsd")}

        def bf16_fn(f):   # a bf16 entry's function: templated on bf16, or named so
            return "bfloat16" in f or "_bf16" in f

        bad = {f"{n}: {f}": c for n, fns in hgmma.items() for f, c in fns.items()
               if (c["hgmma"] == 0 and f != "bwd_dbias_kernel")
               or c["bf16"] != bf16_fn(f) * c["hgmma"]}
        n_bf16 = sum(bf16_fn(f) for fns in hgmma.values() for f in fns)
        # bf16 functions: kernels 1, 2 and 6 one each (64-row blocks at
        # every length), kernel 5 its stats pass (64-row blocks), dk-dv and
        # dq passes
        if bad or n_bf16 != 6:
            raise AssertionError(f"HGMMA by kernel function: {hgmma}")
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
        # the CLIP image tower (one image, 1 + 7*7 tokens), head dim 64;
        # the MaskGIT generator at full width (head dim 48) and the generate
        # CLI's tiny one (head dim 32), whose inputs come from a generator
        # of their own, so that every other row's stay as they were; the
        # U-ViT generator (S 129) and TiTok-S's decoder (S 385), head dim 64
        g_narrow = torch.Generator(device=dev).manual_seed(SEED + 1)
        # the rows at --tp 2's local heads draw from a generator of their own
        g_tp = torch.Generator(device=dev).manual_seed(SEED + 2)
        own = dict.fromkeys(TP_SEQ_SHAPES, g_tp) | dict.fromkeys(
            S128_SEQ_SHAPES, torch.Generator(device=dev).manual_seed(SEED + 3))
        for tag, (B, S, C, heads) in (SEQ_SHAPES | TP_SEQ_SHAPES).items():
            qkv = torch.randn((B, S, 3 * C), device=dev, generator=own.get(
                tag, g if C // heads == 64 else g_narrow))
            scale = (C // heads) ** -0.5
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
                "shape": [B, S, 3 * C], "heads": heads, "head_dim": d,
                "max_abs_err": err, "library_max_abs_err": lib_err,
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
        for C, heads, gen in ((768, 12, g), (1024, 16, g), (384, 6, g_tp), (512, 8, g_tp)):
            qkv = torch.randn((1, 32, 32, 3 * C), device=dev, generator=gen)
            rel = torch.randn((1, s, s), device=dev, generator=gen)
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
        out["window_attention_bwd_bf16"] = bwd16 = self._window_bwd_bf16_checks(g)
        self.kernels["window_attention_nhwc_bwd_bf16"] = bwd16["256px_c768_nb1"]
        out["window_attention_gsd"] = self.kernels["window_attention"] = \
            self._gsd_check(*self._gsd_bench_inputs(g), 64 ** -0.5)

        out.update(self._bf16_kernel_checks(g))

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
        out["group_norm"] = gn = self._group_norm_checks(g)
        self.kernels["group_norm_nhwc"] = gn["flagship_512px_bf16"]
        self.kernels["group_norm_nhwc_f32"] = gn["maskgit_256px_f32"]
        return out

    def _group_norm_checks(self, g):
        """The fused GroupNorm (+ SiLU) against its plain version at
        GN_SHAPES, within GN_TOL, and twice to the same bits; eager and
        device ms beside the plain version's and the library yardstick's:
        PyTorch's composite ops that the port ran before the kernel (f32
        copy, ``F.group_norm`` on the permuted view, cast, ``F.silu``),
        timed only.  ``bound_ms`` is the two-pass design's bytes (x read
        twice, y written once: 6 B an element in bf16, 12 in f32);
        ``one_pass_bound_ms`` the function's own (read once, written once),
        which a kernel reaches only where the statistics come from the
        convolution that makes x: the tensor (537 MB at 512x512) does not
        stay on chip between the two passes.  The input is what the L2
        holds from the previous call, as in the decoder, where the norm
        reads the convolution's fresh output."""
        torch = self.torch
        import torch.nn.functional as F

        from sic_tpu_torch.ops import group_norm_nhwc, group_norm_nhwc_plain
        dev = torch.device("cuda")

        def composite(x, w, b, silu):
            y = F.group_norm(x.float().permute(0, 3, 1, 2), 32, w, b, 1e-6)
            y = y.permute(0, 2, 3, 1).to(x.dtype)
            return F.silu(y) if silu else y

        out = {}
        for tag, (shape, dtype, silu) in GN_SHAPES.items():
            C = shape[-1]
            dt = getattr(torch, dtype)
            x = (torch.randn(shape, device=dev, generator=g) * 2
                 + torch.randn(C, device=dev, generator=g) * 3).to(dt)
            w = 1 + 0.5 * torch.randn(C, device=dev, generator=g)
            b = 0.5 * torch.randn(C, device=dev, generator=g)
            got = group_norm_nhwc(x, w, b, 32, 1e-6, silu)
            want = group_norm_nhwc_plain(x, w, b, 32, 1e-6, silu).float()
            gap = (got.float() - want).abs()
            tol = GN_TOL * float(want.abs().max())
            if dt == torch.bfloat16:     # one ulp of the larger of the two
                big = torch.maximum(got.float().abs(), want.abs()).clamp_min(2.0 ** -126)
                tol = tol + torch.exp2(torch.floor(torch.log2(big)) - 7)
            excess = float((gap - tol).max())
            del want, tol
            n_bytes = x.numel() * x.element_size()
            rec = {"shape": list(shape), "dtype": dtype, "silu": silu,
                   "max_abs_err": float(gap.max()), "excess_over_tol": excess,
                   "deterministic": torch.equal(got, group_norm_nhwc(x, w, b, 32, 1e-6, silu)),
                   "ms": self.time_ms(lambda: group_norm_nhwc(x, w, b, 32, 1e-6, silu)),
                   "device_ms": self.device_ms(
                       lambda: group_norm_nhwc(x, w, b, 32, 1e-6, silu)),
                   "plain_ms": self.time_ms(
                       lambda: group_norm_nhwc_plain(x, w, b, 32, 1e-6, silu), iters=5),
                   "library_ms": self.time_ms(lambda: composite(x, w, b, silu), iters=5),
                   "library_device_ms": self.device_ms(lambda: composite(x, w, b, silu),
                                                       iters=5),
                   "bound_ms": 3 * n_bytes / HBM_BYTES_S * 1e3, "bound_by": "bytes",
                   "one_pass_bound_ms": 2 * n_bytes / HBM_BYTES_S * 1e3}
            rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
            rec["one_pass_bound_share"] = rec["one_pass_bound_ms"] / rec["device_ms"]
            rec["vs_library"] = rec["library_device_ms"] / rec["device_ms"]
            del x, got, gap
            torch.cuda.empty_cache()
            if not (excess <= 0 and rec["deterministic"]):
                raise AssertionError(f"group_norm_nhwc {tag}: {rec}")
            out[tag] = rec
        return out

    def _bf16_row(self, kernel, plain, library, relayout, ref, flops, nbytes):
        """One bf16 entry against its plain bf16 version and the f64
        function on the same inputs: errors, eager and device times beside
        the plain version's and the library call's (SDPA in bf16 on
        pre-laid-out heads, its bias rounded to bf16 as SDPA takes it;
        ``relayout`` brings its output to the kernel's layout, untimed),
        the bound on the bf16 tensor cores and in bytes at 2 bytes an
        element."""
        torch = self.torch
        k_out, p_out = kernel(), plain()
        lib = relayout(library())
        f64 = (k_out.double() - ref).abs().max().item()
        plain_f64 = (p_out.double() - ref).abs().max().item()
        rec = {"dtype": "bfloat16", "max_abs_err": (k_out.float() - p_out.float()).abs().max().item(),
               "f64_max_abs_err": f64, "plain_f64_max_abs_err": plain_f64,
               "f64_err_ratio": f64 / plain_f64 if plain_f64 else None,
               "library_f64_max_abs_err": (lib.double() - ref).abs().max().item(),
               "finite": bool(torch.isfinite(k_out).all()),
               "deterministic": torch.equal(k_out, kernel()),
               "ms": self.time_ms(kernel), "plain_ms": self.time_ms(plain),
               "library_ms": self.time_ms(library),
               "device_ms": self.device_ms(kernel),
               "library_device_ms": self.device_ms(library)}
        rec["vs_library"] = rec["device_ms"] / rec["library_device_ms"]
        rec["bound_ms"], rec["bound_by"] = self.bf16_bound(flops, nbytes)
        rec["tc_bound_ms"] = flops / BF16_TFLOPS * 1e3
        if not (k_out.dtype == torch.bfloat16 and rec["finite"] and rec["deterministic"]
                and f64 <= BF16_F64_RATIO * plain_f64):
            raise AssertionError(f"bf16 entry: {rec}")
        return rec

    def _bf16_kernel_checks(self, g):
        """The bf16 entries of kernels 1, 2 and 6 at the f32 rows' shapes."""
        torch = self.torch
        import torch.nn.functional as F

        from sic_tpu_torch import ops
        from sic_tpu_torch.models.swin import _full_shift_mask
        dev, bf = torch.device("cuda"), torch.bfloat16
        out = {}
        g_narrow = torch.Generator(device=dev).manual_seed(SEED + 2)
        g_s128 = torch.Generator(device=dev).manual_seed(SEED + 3)
        for tag, (B, S, C, heads) in SEQ_SHAPES.items():
            gen = g_s128 if tag in S128_SEQ_SHAPES else g if C // heads == 64 else g_narrow
            qkv = torch.randn((B, S, 3 * C), device=dev, generator=gen).to(bf)
            d = C // heads
            scale = d ** -0.5
            q, k, v = (t.view(B, S, heads, d).transpose(1, 2) for t in qkv.split(C, dim=-1))
            out[f"seq_attention_bf16_{tag}"] = self._bf16_row(
                lambda: ops.seq_attention(qkv, scale, heads),
                lambda: ops.seq_attention_plain(qkv, scale, heads),
                lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                lambda o: o.transpose(1, 2).reshape(B, S, C),
                self._seq_f64(qkv, scale, heads),
                4 * B * heads * S * S * d, B * S * 4 * C * 2)
            out[f"seq_attention_bf16_{tag}"]["head_dim"] = d
        self.kernels["seq_attention_bf16"] = out["seq_attention_bf16_trunk"]
        scale = 64 ** -0.5
        ws, s = 16, 256
        for C, heads in ((768, 12), (1024, 16)):
            qkv = torch.randn((1, 32, 32, 3 * C), device=dev, generator=g).to(bf)
            rel = torch.randn((1, s, s), device=dev, generator=g)
            d = C // heads
            t = qkv.reshape(1, 2, ws, 2, ws, 3, heads, d).permute(
                5, 0, 1, 3, 6, 2, 4, 7).reshape(3, 4, heads, s, d).contiguous()
            for nB in (1, 4):
                bias = rel if nB == 1 else (rel + torch.from_numpy(
                    _full_shift_mask(2, 2, ws)).to(dev)).contiguous()
                mask = bias.to(bf).expand(4, s, s)[:, None]
                out[f"window_attention_bf16_c{C}_nb{nB}"] = self._bf16_row(
                    lambda: ops.window_attention_nhwc(qkv, bias, scale, heads),
                    lambda: ops.window_attention_nhwc_plain(qkv, bias, scale, heads),
                    lambda: F.scaled_dot_product_attention(
                        t[0], t[1], t[2], attn_mask=mask, scale=scale),
                    lambda o: self._from_gsd(o.transpose(0, 1).reshape(heads * 4, s, d),
                                             1, 32, 32, heads, ws),
                    self._window_f64(qkv, bias, scale, heads),
                    4 * 4 * heads * s * s * d, 32 * 32 * 4 * C * 2 + nB * s * s * 4)
        self.kernels["window_attention_nhwc_bf16"] = out["window_attention_bf16_c768_nb4"]
        q, k, v, bias = self._gsd_bench_inputs(g)
        out["window_attention_gsd_bf16"] = self.kernels["window_attention_bf16"] = \
            self._gsd_bf16_row(q.to(bf), k.to(bf), v.to(bf), bias, scale)
        return out

    def _gsd_bf16_row(self, q, k, v, bias, scale):
        """Kernel 6's bf16 entry (f32 bias) as :meth:`_bf16_row` measures it."""
        import torch.nn.functional as F

        from sic_tpu_torch import ops
        G, s, d = q.shape
        nW = bias.shape[0]
        qb, kb, vb = (t.view(G // nW, nW, s, d) for t in (q, k, v))
        mask = bias.to(q.dtype)[None]
        rec = self._bf16_row(
            lambda: ops.window_attention(q, k, v, bias, scale),
            lambda: ops.window_attention_plain(q, k, v, bias, scale),
            lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask,
                                                   scale=scale),
            lambda o: o.reshape(G, s, d),
            self._gsd_f64(q, k, v, bias, scale),
            4 * G * s * s * d, 4 * G * s * d * 2 + nW * s * s * 4)
        rec.update(shape=[G, s, d], nW=nW)
        return rec

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

    def _window_bwd_bf16_checks(self, g):
        """Kernel 5's bf16 entry at the two training shapes (the 256-px
        detail branch, nB 1; the 512-px maps with the shifted layers' -inf
        masks, nB 4), batch 2: dqkv's error against f64 within
        BF16_F64_RATIO of the plain bf16 version's (f32 inside, rounded
        once, as the TPU kernel computes), dbias (f32) within BWD_TOL of
        the plain version's, two launches bit-equal; eager and device times
        beside the plain version's and SDPA's bf16 autograd backward (the
        sum of its kernels in a profiler trace); the bound on the bf16
        tensor cores against 2 bytes an element of qkv, g and dqkv."""
        torch = self.torch
        import torch.nn.functional as F

        from sic_tpu_torch import ops
        from sic_tpu_torch.models.swin import _full_shift_mask
        dev, bf = torch.device("cuda"), torch.bfloat16
        ws, s, scale = 16, 256, 64 ** -0.5
        out = {}
        for tag, (B, H, W, C, shifted) in {"256px_c768_nb1": (2, 16, 16, 768, False),
                                           "512px_c768_nb4": (2, 32, 32, 768, True)}.items():
            heads, d = C // 64, 64
            nwh, nww = H // ws, W // ws
            nW = nwh * nww
            qkv = torch.randn((B, H, W, 3 * C), device=dev, generator=g).to(bf)
            gout = torch.randn((B, H, W, C), device=dev, generator=g).to(bf)
            bias = torch.randn((1, s, s), device=dev, generator=g)
            if shifted:
                bias = (bias + torch.from_numpy(_full_shift_mask(nwh, nww, ws))
                        .to(dev)).contiguous()
            nB = bias.shape[0]

            def kernel():
                return ops.window_attention_nhwc_bwd(qkv, bias, gout, scale, heads)

            def plain():
                return ops.window_attention_nhwc_bwd_plain(qkv, bias, gout, scale, heads)

            dq, db = kernel()
            pq, pb = plain()
            again = kernel()
            deterministic = torch.equal(dq, again[0]) and torch.equal(db, again[1])
            fq, fb = self._window_bwd_f64(qkv, bias, gout, scale, heads)
            f64 = (dq.double() - fq).abs().max().item()
            plain_f64 = (pq.double() - fq).abs().max().item()
            rec = {"shape": [B, H, W, 3 * C], "dtype": "bfloat16", "heads": heads,
                   "nB": nB, "shift_masks": shifted,
                   "max_abs_err": (dq.float() - pq.float()).abs().max().item(),
                   "f64_max_abs_err": f64, "plain_f64_max_abs_err": plain_f64,
                   "f64_err_ratio": f64 / plain_f64 if plain_f64 else None,
                   "dbias_rel_err": self._rel(db, pb.double()),
                   "f64_dbias_rel_err": self._rel(db, fb),
                   "plain_f64_dbias_rel_err": self._rel(pb, fb),
                   "finite": bool(torch.isfinite(dq.float()).all() and torch.isfinite(db).all()),
                   "deterministic": deterministic}
            del fq, fb, again
            t = qkv.reshape(B, nwh, ws, nww, ws, 3, heads, d).permute(
                5, 0, 1, 3, 6, 2, 4, 7).reshape(3, B * nW, heads, s, d)
            q, k, v = (t[i].contiguous().requires_grad_(True) for i in range(3))
            leaf = bias.to(bf).requires_grad_(True)
            win = torch.arange(B * nW, device=dev) % nW % nB
            lib_out = F.scaled_dot_product_attention(q, k, v, attn_mask=leaf[win][:, None],
                                                     scale=scale)
            lib_g = torch.randn_like(lib_out)

            def library():
                return torch.autograd.grad(lib_out, (q, k, v, leaf), lib_g,
                                           retain_graph=True)

            rec.update({"ms": self.time_ms(kernel, iters=10),
                        "plain_ms": self.time_ms(plain, iters=10),
                        "library_ms": self.time_ms(library, iters=10),
                        "device_ms": self.device_ms(kernel), "device_method": "cuda_graph",
                        "library_device_ms": self.profiled_device_ms(library),
                        "library_device_method": "profiler"})
            rec["profiler_device_ms"], rec["passes_device_ms"] = \
                self.profiled_device_ms(kernel, by_kernel=True)
            rec["vs_library"] = rec["device_ms"] / rec["library_device_ms"]
            flops = 10 * B * nW * heads * s * s * d
            rec["bound_ms"], rec["bound_by"] = self.bf16_bound(
                flops, B * H * W * (3 * C + C + 3 * C) * 2 + 2 * nB * s * s * 4)
            rec["tc_bound_ms"] = flops / BF16_TFLOPS * 1e3
            if not (dq.dtype == bf and rec["finite"] and deterministic
                    and f64 <= BF16_F64_RATIO * plain_f64
                    and rec["dbias_rel_err"] <= BWD_TOL):
                raise AssertionError(f"window_attention_bwd bf16 {tag}: {rec}")
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
                         "--device", "cuda", "--dtype", "float32"])
        cli_max, cli_frac = bound(np.asarray(Image.open(dst / "golden.png")))

        rt = load_runtime(str(GOLDEN / "params.npz"), tiny_spec(), device="cuda",
                          dtype="float32")
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
                          stream_part=1, dtype="float32")
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
        rt = self.rt = load_runtime(None, spec, device="cuda", stream_part=4,
                                    dtype="float32")
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
                             "--spec", "flagship", "--device", "cuda",
                             "--dtype", "float32"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t1
        encs, probes = {}, {}
        for mode in ("device", "host"):
            probes[mode] = {}
            encs[mode] = run(mode, probes[mode])
        self.read_counts("encode")
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
        # the host coder's fan-out over the group of eight: its packed
        # planes coded on one thread and on eight, byte-equal
        with torch.no_grad():
            _z, h = rt._encode_networks(rt._images(x["group_of_8"]), False)
            packed = [p.cpu().numpy() for _s, _r, p, _y in
                      rt.h_coder.compress_plan_chunks(h)]

        def host_encode(workers):
            return [s for p in packed
                    for s in rt.h_coder.encode_packed_many(p, workers=workers)]

        out["host_encode_group_of_8_workers_ms_p50"] = {
            str(w): median_ms(lambda w=w: host_encode(w)) for w in (1, 8)}
        out["host_encode_workers_bytes_equal"] = host_encode(1) == host_encode(8)
        out["cpu_count"] = os.cpu_count()
        if not out["host_encode_workers_bytes_equal"]:
            raise AssertionError("encode_packed_many: workers 8 differ from workers 1")
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
                                 "--spec", "flagship", "--device", "cuda",
                                 "--dtype", "float32"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t1
        counts = self.read_counts("decode")
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
        stages = self._timer_stages(requests["a_512x512"])
        rec = {"spec": "flagship", "dtype": "float32", "files": n_cli,
               "stream_bytes": {s: len(e["h_bit_stream"]) for s, e in requests.items()},
               "h_paths": paths, "h_hat_bit_exact": exact,
               "request_ms": ms, "cli_s": round(cli_s, 3), "peak_mem_gb": peak_gb,
               "cli_vs_runtime_max_u8_diff": cli_diff,
               "timer_stage_ms": stages, "launches": counts, **timing}
        rec["group_norm"] = gn = self.gn_counts["decode"]
        need = ("seq_attention", "window_attention_nhwc", "rans_decode_plane")
        if n_cli != 6 or not all(exact.values()) \
                or min(counts[k] for k in need) < 1 \
                or gn["composite"] != 0 or gn["launches"] < 39 \
                or paths["a_512x512"] != "device" or max(cli_diff.values()) > 1 \
                or set(stages["decode_only"]) != {"z_rans", "h_rans", "decode_device"} \
                or set(stages["encode_only"]) != {"encode_device", "fetch", "h_rans",
                                                  "z_rans"}:
            raise AssertionError(f"flagship decode check failed: {rec}")
        return rec

    def _timer_stages(self, request):
        """One decode_only and one encode_only of the 512x512 request with
        ``timer=StageTimer()``: the JAX runtime's stage names, and each
        stage's ms (host clock; a stage that ends with work queued on the
        card counts its enqueue)."""
        torch = self.torch
        from sic_tpu_torch.data import load_image
        from sic_tpu_torch.utils.profiling import StageTimer
        rt, out = self.rt, {}
        timer = StageTimer()
        rt.decode_only(**request, timer=timer, output="u8")
        torch.cuda.synchronize()
        out["decode_only"] = dict(timer.stages)
        timer = StageTimer()
        rt.encode_only(load_image(WORK / "encode_in" / "a_512x512.png")[None], timer=timer)
        torch.cuda.synchronize()
        out["encode_only"] = dict(timer.stages)
        return out

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
            **{f"group_of_4_host_workers_{w}": median_ms(
                lambda w=w: rt.h_coder.decompress_batched(
                    [requests[s]["h_bit_stream"] for s in group],
                    (1, 8, 8, rt.spec.quant_dim), workers=w, coding_batch=8))
               for w in (1, 8)}}}
        # the host decoders' fan-out: one thread and eight, the same y_hat
        y = {w: rt.h_coder.decompress_batched(
            [requests[s]["h_bit_stream"] for s in group], (1, 8, 8, rt.spec.quant_dim),
            workers=w, coding_batch=8) for w in (1, 8)}
        out["host_decode_workers_y_hat_equal"] = bool(torch.equal(y[1], y[8]))
        if not out["host_decode_workers_y_hat_equal"]:
            raise AssertionError("decompress_batched: workers 8 differ from workers 1")

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
        shift masks), in f32 and through the bf16 entry (q, k, v in bf16).
        Then the layer's output against kernel 2's on the same qkv, in both
        dtypes, and the layer shape against the plain version, timed."""
        torch = self.torch

        from sic_tpu_torch import ops
        g = torch.Generator(device="cuda").manual_seed(SEED + 6)
        bench = self._gsd_bench_inputs(g)
        qkv, bias, heads, scale = self._layer_qkv()
        B, H, W, _ = qkv.shape
        layer = (*self._to_gsd(qkv, heads, 16), bias)
        bf = torch.bfloat16
        bench_bf, layer_bf = ((*(t.to(bf) for t in x[:3]), x[3]) for x in (bench, layer))

        # -- the op's path: counts from 0, read right after ----------------------
        ops.reset_launch_counts()
        for inputs, sc in ((bench, 64 ** -0.5), (layer, scale),
                           (bench_bf, 64 ** -0.5), (layer_bf, scale)):
            self._gsd_grads(ops.window_attention, *inputs, sc)
        torch.cuda.synchronize()
        counts = self.read_counts("op")
        # -------------------------------------------------------------------------

        vs_k2 = {}
        for name, x, lay in (("f32", qkv, layer), ("bf16", qkv.to(bf), layer_bf)):
            out6 = ops.window_attention(*lay, scale)
            out2 = ops.window_attention_nhwc(x, bias, scale, heads)
            vs_k2[name] = ((self._from_gsd(out6, B, H, W, heads, 16).float()
                            - out2.float()).abs().max() / out2.float().abs().max()).item()
        rec = {"layer": "prior_fusion.feat_in.block.1 (shifted), 512x512 request",
               "qkv_shape": list(qkv.shape), "heads": heads, "nW": bias.shape[0],
               "qkv_max_abs": qkv.abs().max().item(),
               "vs_window_attention_nhwc_rel_err": vs_k2,
               "layer_check": self._gsd_check(*layer, scale),
               "layer_check_bf16": self._gsd_bf16_row(*layer_bf, scale),
               "launches": counts, "bf16_launches": self.bf16_counts["op"],
               "model_path_launches": {p: c.get("window_attention", 0)
                                       for p, c in self.counts.items() if p != "op"}}
        if counts["window_attention"] < 1 or \
                self.bf16_counts["op"]["window_attention"] < 1 or \
                max(vs_k2.values()) > GSD_FWD_TOL:
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
            state = ServiceState("flagship", device="cuda", dtype="float32")
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
        counts = self.read_counts("serve")
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
               "latency_ms_p50": latency, "launches": counts,
               "group_norm": self.gn_counts["serve"]}

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
                and rec["group_norm"]["composite"] == 0
                and rec["group_norm"]["launches"] >= 39
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
        counts = self.read_counts("surface")
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
        summary = evaluate_main(["--dataset_dir", str(HELDOUT), "--device", "cuda",
                                 "--dtype", "float32"],
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
        common = ["--base_config", str(cfg), "--device", "cuda", "--dtype", "float32",
                  "--batch_size", "1"]
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
            state = ServiceState(device="cuda", dtype="float32")
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

    # -- the bf16 phase ----------------------------------------------------------
    def bf16(self):
        """The bf16 serving mode at flagship width, on load_runtime's
        default (bf16 on CUDA, as the JAX package serves on an
        accelerator): encode_only of the 512x512 and 256x768 images and
        encode_only_batched of the eight 256x256 (the encode kernel's
        coder, as phase 4 drives it; the router picks the host coder for
        these), each stream decoding to
        its encoder's y_hat exactly through the bf16 and the fp32 runtime;
        decode_only and decode_only_batched of the decode phase's streams
        (h_hat equal to y_hat; pixels against the fp32 runtime's within the
        bound fixtures/golden_bf16.py derives from the JAX package's own
        bf16-vs-fp32 gap); the compress and decompress CLIs and one served
        /compress and /decompress, none given a dtype; then request times
        of bf16 beside fp32 and one profiled bf16 decode."""
        import gc

        import numpy as np
        torch = self.torch
        from PIL import Image

        from sic_tpu_torch import ops
        from sic_tpu_torch.cli._common import load_runtime
        from sic_tpu_torch.cli.compress import main as compress_main
        from sic_tpu_torch.cli.decompress import main as decompress_main
        from sic_tpu_torch.config import flagship_spec
        from sic_tpu_torch.container import unpack_c2df
        from sic_tpu_torch.data import load_image
        sys.path.insert(0, str(ROOT / "tests"))
        from fixtures.golden_bf16 import GAP_MULTIPLE, JAX_GAP_MAX, JAX_GAP_MEAN
        rt32 = self.rt
        t0 = time.perf_counter()
        rt = load_runtime(None, flagship_spec(), device="cuda", stream_part=4)
        init_s = time.perf_counter() - t0
        same_weights = all(torch.equal(a, b) for a, b in
                           zip(rt.model.parameters(), rt32.model.parameters()))
        src = WORK / "encode_in"
        img = {p.stem: load_image(p) for p in sorted(src.glob("*.png"))}
        x = {"a_512x512": img["a_512x512"][None], "b_256x768": img["b_256x768"][None],
             "group_of_8": np.stack([img[f"c_256x256_{i}"] for i in range(8)])}
        requests = {k: {f: v for f, v in e.items() if f != "y_hat"}
                    for k, e in self.requests.items()}
        group = [f"c_256x256_{i}" for i in range(4)]

        def encode(probes=None):
            def probe(k):
                return None if probes is None else probes.setdefault(k, {})
            out = {k: rt.encode_only(x[k], probe=probe(k)) for k in ("a_512x512", "b_256x768")}
            out["group_of_8"] = rt.encode_only_batched(x["group_of_8"], probe=probe("group_of_8"))
            return out

        def decode(r, output="float", probes=None):
            def probe(k):
                return None if probes is None else probes.setdefault(k, {})
            out = {k: r.decode_only(**requests[k], output=output, probe=probe(k))
                   for k in ("a_512x512", "b_256x768")}
            out["group_of_4"] = r.decode_only_batched([requests[k] for k in group],
                                                      output=output, probe=probe("group_of_4"))
            torch.cuda.synchronize()
            return out

        encode()          # warm-up (cuBLAS/cuDNN handles), not counted
        decode(rt)

        # -- the bf16 main path: counts from 0, read right after ---------------------
        ops.reset_launch_counts()
        enc_probes, dec_probes = {}, {}
        rt.device_entropy = "device"     # the encode kernel's coder, as phase 4
        encs = encode(enc_probes)
        rt.device_entropy = "auto"
        x_bf = decode(rt, probes=dec_probes)
        cli_in, cli_out = WORK / "bf16_cli_in", WORK / "bf16_cli_out"
        shutil.rmtree(cli_in, ignore_errors=True)
        cli_in.mkdir(parents=True)
        shutil.copy(src / "a_512x512.png", cli_in)
        shutil.copy(src / "c_256x256_0.png", cli_in)
        t1 = time.perf_counter()
        cli = compress_main(["--dataset_dir", str(cli_in), "--save_dir", str(cli_out),
                             "--spec", "flagship", "--device", "cuda"])
        n_dec = decompress_main(["--dataset_dir", str(cli_out / "bitstreams"),
                                 "--save_dir", str(cli_out / "png"), "--spec", "flagship",
                                 "--device", "cuda"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t1
        served = self._bf16_serve(src / "a_512x512.png")
        torch.cuda.synchronize()
        counts = self.read_counts("bf16")
        bf16_counts = self.bf16_counts["bf16"]
        # ------------------------------------------------------------------------------

        # every stream the bf16 encode wrote decodes to its y_hat in both dtypes
        exact = {}
        for name, r in (("bf16", rt), ("fp32", rt32)):
            for k in ("a_512x512", "b_256x768"):
                d = {}
                r.decode_only(**encs[k], coding_batch=8, probe=d)
                exact[f"encode_{k}_{name}"] = bool(torch.equal(d["h_hat"],
                                                               enc_probes[k]["y_hat"]))
            d = {}
            r.decode_only_batched([dict(e, coding_batch=8) for e in encs["group_of_8"]],
                                  probe=d)
            exact[f"encode_group_of_8_{name}"] = bool(torch.equal(
                d["h_hat"], enc_probes["group_of_8"]["y_hat"]))
        # the decode phase's streams: the encoder's y_hat, pixels near fp32's
        for k in ("a_512x512", "b_256x768"):
            exact[f"decode_{k}"] = bool(torch.equal(dec_probes[k]["h_hat"],
                                                    self.requests[k]["y_hat"]))
        exact["decode_group_of_4"] = bool(torch.equal(
            dec_probes["group_of_4"]["h_hat"],
            torch.cat([self.requests[k]["y_hat"] for k in group])))
        x32 = decode(rt32)
        pixels = {k: {"max_abs_diff": (x_bf[k] - x32[k]).abs().max().item(),
                      "mean_abs_diff": (x_bf[k] - x32[k]).abs().mean().item()}
                  for k in x_bf}
        bound = {"max": GAP_MULTIPLE * JAX_GAP_MAX, "mean": GAP_MULTIPLE * JAX_GAP_MEAN}
        # the CLIs' files: the runtime's bytes for the same image, PNGs written
        cli_a = unpack_c2df(cli_out / "bitstreams" / "a_512x512.c2df")[0]
        cli_equal = (cli_a["h_bit_stream"] == encs["a_512x512"]["h_bit_stream"]
                     and cli_a["z_bit_stream"] == encs["a_512x512"]["z_bit_stream"])
        png = np.asarray(Image.open(cli_out / "png" / "a_512x512.png"))
        timing = self._bf16_timing(rt, rt32, x, requests, group)
        rec = {"spec": "flagship", "dtype": str(rt.dtype).replace("torch.", ""),
               "init_s": round(init_s, 3), "same_weights_as_fp32_runtime": same_weights,
               "h_hat_bit_exact": exact, "pixels_vs_fp32": pixels,
               "pixel_bound": bound,
               "pixel_bound_source": "fixtures/golden_bf16.py: 2 x the JAX package's "
                                     "bf16-vs-fp32 gap on golden.c2df (CPU)",
               "cli": cli, "cli_files": n_dec, "cli_s": round(cli_s, 3),
               "cli_streams_equal_runtime": cli_equal, "cli_png_shape": list(png.shape),
               "served": served, "launches": counts, "bf16_launches": bf16_counts,
               "group_norm": self.gn_counts["bf16"],
               "h_paths": {k: v.get("h_path")
                           for k, v in {**enc_probes, **dec_probes}.items()},
               **timing}
        rt.close()
        del rt
        gc.collect()
        torch.cuda.empty_cache()
        need = ("seq_attention", "window_attention_nhwc")
        if not (rec["dtype"] == "bfloat16" and same_weights and all(exact.values())
                and all(p["max_abs_diff"] <= bound["max"]
                        and p["mean_abs_diff"] <= bound["mean"] for p in pixels.values())
                and cli["images"] == 2 and n_dec == 2 and cli_equal
                and png.shape == (512, 512, 3) and served["ok"]
                and min(bf16_counts[k] for k in need) >= 1
                and counts["rans_decode_plane"] >= 1 and counts["rans_encode_plane"] >= 1
                and counts["window_attention"] == 0
                and rec["group_norm"]["composite"] == 0
                and rec["group_norm"]["launches"] >= 39
                and {enc_probes[k]["h_path"] for k in enc_probes} == {"device"}):
            raise AssertionError(f"bf16 phase: {rec}")
        return rec

    def _bf16_serve(self, image, quant=None):
        """One /compress and one /decompress of the service with no dtype
        given (its default, bf16 on CUDA) and ``SIC_QUANT`` set to
        ``quant`` (unset for None): its runtime's dtype and quant mode, the
        response headers, and its PNG against the served stream decoded by
        that runtime."""
        import gc
        import io
        import os

        import numpy as np
        torch = self.torch
        from PIL import Image

        from sic_tpu_torch.container import sanitize_enc_result_types, unpack_c2df
        from sic_tpu_torch.service import ServiceState, make_server
        env = {"INDEX_DIR": str(WORK / "encode_out" / "faiss"),
               "MEDIA_ROOT": str(WORK), "PREVIEW_CACHE": str(WORK / "previews")}
        saved = {k: os.environ.get(k) for k in (*env, "SIC_DTYPE", "SIC_QUANT")}
        os.environ.update(env)
        os.environ.pop("SIC_DTYPE", None)
        os.environ.pop("SIC_QUANT", None)
        if quant is not None:
            os.environ["SIC_QUANT"] = quant
        try:
            state = ServiceState("flagship", device="cuda")
            state.runtime       # loads now, while SIC_QUANT is set
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

        def post(path, payload, name):
            body, ctype = _multipart(name, payload)
            req = urllib.request.Request(base + path, data=body,
                                         headers={"Content-Type": ctype})
            with urllib.request.urlopen(req, timeout=600) as resp:
                return resp.read(), dict(resp.headers)

        try:
            c2df, hdr_c = post("/compress", image.read_bytes(), image.name)
            png, hdr_d = post("/decompress", c2df, "a.c2df")
            rt = state.runtime
            enc, header = unpack_c2df(c2df)
            enc = dict(sanitize_enc_result_types(enc), z_coder=header["z_coder"],
                       coding_batch=header["coding_batch"])
            want = rt.decode_only(**enc, output="u8")[0].cpu().numpy()
            rec = {"dtype": str(rt.dtype).replace("torch.", ""), "quant": rt.quant,
                   "compress_stage": hdr_c.get("X-SIC-Stage"),
                   "decompress_stage": hdr_d.get("X-SIC-Stage"),
                   "png_equals_decode_only": bool(np.array_equal(
                       np.asarray(Image.open(io.BytesIO(png))), want))}
        finally:
            srv.shutdown()
            srv.server_close()
            th.join()
            state.close()
            del state, srv, th
            gc.collect()
            torch.cuda.empty_cache()
        rec["ok"] = (rec["dtype"] == "bfloat16" and rec["quant"] == quant
                     and rec["png_equals_decode_only"]
                     and rec["decompress_stage"] == "decompress")
        return rec

    def _bf16_timing(self, rt, rt32, x, requests, group, reps=5):
        """Request times, median of ``reps``, of the bf16 and the fp32
        runtime in turns (fp32, bf16), the encode kernel's coder on both;
        and one profiled bf16 decode of the 512x512 stream."""
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

        calls = {
            "encode_a_512x512": lambda r: r.encode_only(x["a_512x512"]),
            "encode_b_256x768": lambda r: r.encode_only(x["b_256x768"]),
            "encode_group_of_8": lambda r: r.encode_only_batched(x["group_of_8"]),
            "decode_a_512x512": lambda r: r.decode_only(**requests["a_512x512"],
                                                        output="u8"),
            "decode_b_256x768": lambda r: r.decode_only(**requests["b_256x768"],
                                                        output="u8"),
            "decode_group_of_4": lambda r: r.decode_only_batched(
                [requests[k] for k in group], output="u8")}
        out = {"fp32": {}, "bf16": {}}
        for r in (rt, rt32):
            r.device_entropy = "device"
        try:
            for name, fn in calls.items():
                for tag, r in (("fp32", rt32), ("bf16", rt)):
                    out[tag][name] = median_ms(lambda: fn(r))
        finally:
            for r in (rt, rt32):
                r.device_entropy = "auto"
        return {"request_ms_p50": out,
                "profile_decode_512x512": self._profile(
                    lambda: rt.decode_only(**requests["a_512x512"], output="u8"))}

    # -- phase 10 ---------------------------------------------------------------
    def int8(self):
        """The W8A8 int8 serving mode at flagship width through
        load_runtime(quant="int8"), in fp32 and in bf16: encode_only of the
        512x512 image and encode_only_batched of the eight 256x256 with the
        encode kernel's coder, decode_only of the decode phase's 512x512
        stream and decode_only_batched of the eight int8 streams; the compress
        and decompress CLIs with --quant int8; one served /compress and
        /decompress under SIC_QUANT=int8.  Every int8 stream decodes to its
        encoder's y_hat in the fp32, bf16, int8 and int8+bf16 runtimes; every
        Linear left float is one of the two sensitive ones; the pixels' gap
        to fp32 is reported (and held to the JAX package's cascade bound on
        seeded weights, relative norm < 0.3).  Then request times of the four
        modes, one profiled int8 decode, and the int8 GEMM at the flagship's
        Linear shapes against bf16 and fp32 F.linear."""
        import gc

        import numpy as np
        torch = self.torch
        from PIL import Image

        from sic_tpu_torch import ops
        from sic_tpu_torch.cli._common import load_runtime
        from sic_tpu_torch.cli.compress import main as compress_main
        from sic_tpu_torch.cli.decompress import main as decompress_main
        from sic_tpu_torch.config import flagship_spec
        from sic_tpu_torch.container import unpack_c2df
        from sic_tpu_torch.data import load_image
        from sic_tpu_torch.models import CodecRuntime
        from sic_tpu_torch.models.layers import Linear
        from sic_tpu_torch.ops.quant import QuantLinear, int8_mm
        sys.path.insert(0, str(ROOT / "tests"))
        from fixtures.golden_int8 import GAP_MULTIPLE, JAX_GAP_MAX, JAX_GAP_MEAN
        rt32 = self.rt
        t0 = time.perf_counter()
        rts = {name: load_runtime(None, flagship_spec(), device="cuda", stream_part=4,
                                  dtype=dtype, quant="int8")
               for name, dtype in (("int8_fp32", "float32"), ("int8_bf16", "bfloat16"))}
        init_s = time.perf_counter() - t0
        rt_bf = CodecRuntime(flagship_spec(), rt32.model, stream_part=4,
                             dtype=torch.bfloat16)
        same_weights = all(torch.equal(a, b) for r in rts.values() for a, b in
                           zip(r.model.parameters(), rt32.model.parameters()))
        layers = {name: {"quant_linears": sum(isinstance(m, QuantLinear)
                                              for m in r.net.modules()),
                         "float_linears": sorted(n for n, m in r.net.named_modules()
                                                 if isinstance(m, Linear))}
                  for name, r in rts.items()}
        src = WORK / "encode_in"
        img = {p.stem: load_image(p) for p in sorted(src.glob("*.png"))}
        x = {"a_512x512": img["a_512x512"][None],
             "group_of_8": np.stack([img[f"c_256x256_{i}"] for i in range(8)])}
        requests = {k: {f: v for f, v in e.items() if f != "y_hat"}
                    for k, e in self.requests.items()}

        def encode(r, probes=None):
            def probe(k):
                return None if probes is None else probes.setdefault(k, {})
            r.device_entropy = "device"      # the encode kernel's coder
            try:
                return {"a_512x512": r.encode_only(x["a_512x512"], probe=probe("a_512x512")),
                        "group_of_8": r.encode_only_batched(x["group_of_8"],
                                                            probe=probe("group_of_8"))}
            finally:
                r.device_entropy = "auto"

        def decode(r, group_of_8, probes=None):
            def probe(k):
                return None if probes is None else probes.setdefault(k, {})
            out = {"a_512x512": r.decode_only(**requests["a_512x512"], probe=probe("a_512x512")),
                   "group_of_8": r.decode_only_batched(
                       [dict(e, coding_batch=8) for e in group_of_8], probe=probe("group_of_8"))}
            torch.cuda.synchronize()
            return out

        for r in rts.values():           # warm-up (cuBLASLt heuristics), not counted
            decode(r, encode(r)["group_of_8"])

        # -- the int8 main path: counts from 0, read right after ---------------------
        ops.reset_launch_counts()
        enc_probes = {name: {} for name in rts}
        dec_probes = {name: {} for name in rts}
        encs, x_hat = {}, {}
        for name, r in rts.items():
            encs[name] = encode(r, enc_probes[name])
            x_hat[name] = decode(r, encs[name]["group_of_8"], dec_probes[name])
        cli_in, cli_out = WORK / "int8_cli_in", WORK / "int8_cli_out"
        shutil.rmtree(cli_in, ignore_errors=True)
        cli_in.mkdir(parents=True)
        shutil.copy(src / "a_512x512.png", cli_in)
        shutil.copy(src / "c_256x256_0.png", cli_in)
        t1 = time.perf_counter()
        cli = compress_main(["--dataset_dir", str(cli_in), "--save_dir", str(cli_out),
                             "--spec", "flagship", "--device", "cuda", "--quant", "int8"])
        n_dec = decompress_main(["--dataset_dir", str(cli_out / "bitstreams"),
                                 "--save_dir", str(cli_out / "png"), "--spec", "flagship",
                                 "--device", "cuda", "--quant", "int8"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t1
        served = self._bf16_serve(src / "a_512x512.png", quant="int8")
        torch.cuda.synchronize()
        int8_launches = int8_mm.launches
        counts = self.read_counts("int8")
        # ------------------------------------------------------------------------------

        # every int8 stream decodes to its encoder's y_hat in all four modes
        exact = {}
        modes = {"fp32": rt32, "bf16": rt_bf, **rts}
        for ename in rts:
            for dname, r in modes.items():
                d = {}
                r.decode_only(**encs[ename]["a_512x512"], coding_batch=8, probe=d)
                exact[f"{ename}_a_512x512_in_{dname}"] = bool(torch.equal(
                    d["h_hat"], enc_probes[ename]["a_512x512"]["y_hat"]))
                d = {}
                r.decode_only_batched([dict(e, coding_batch=8)
                                       for e in encs[ename]["group_of_8"]], probe=d)
                exact[f"{ename}_group_of_8_in_{dname}"] = bool(torch.equal(
                    d["h_hat"], enc_probes[ename]["group_of_8"]["y_hat"]))
            # the decode phase's fp32 stream, read by the int8 runtime
            exact[f"decode_a_512x512_{ename}"] = bool(torch.equal(
                dec_probes[ename]["a_512x512"]["h_hat"], self.requests["a_512x512"]["y_hat"]))
        x32 = {"a_512x512": rt32.decode_only(**requests["a_512x512"]),
               "group_of_8": {n: rt32.decode_only_batched(
                   [dict(e, coding_batch=8) for e in encs[n]["group_of_8"]]) for n in rts}}
        pixels = {}
        for name in rts:
            for k, ref in (("a_512x512", x32["a_512x512"]),
                           ("group_of_8", x32["group_of_8"][name])):
                got = x_hat[name][k]
                pixels[f"{name}_{k}"] = {
                    "max_abs_diff": (got - ref).abs().max().item(),
                    "mean_abs_diff": (got - ref).abs().mean().item(),
                    "rel_norm": (torch.linalg.norm(got - ref)
                                 / torch.linalg.norm(ref)).item()}
        golden_bound = {"max": GAP_MULTIPLE * JAX_GAP_MAX, "mean": GAP_MULTIPLE * JAX_GAP_MEAN}
        cli_a = unpack_c2df(cli_out / "bitstreams" / "a_512x512.c2df")[0]
        cli_equal = (cli_a["h_bit_stream"] == encs["int8_bf16"]["a_512x512"]["h_bit_stream"]
                     and cli_a["z_bit_stream"] == encs["int8_bf16"]["a_512x512"]["z_bit_stream"])
        png = np.asarray(Image.open(cli_out / "png" / "a_512x512.png"))
        timing = self._int8_timing(rts, rt32, rt_bf, x, requests)
        rec = {"spec": "flagship", "init_s": round(init_s, 3),
               "dtypes": {n: str(r.dtype).replace("torch.", "") for n, r in rts.items()},
               "quant": {n: r.quant for n, r in rts.items()},
               "same_weights_as_fp32_runtime": same_weights, "layers": layers,
               "h_hat_bit_exact": exact, "pixels_vs_fp32": pixels,
               "golden_derived_bound": golden_bound,
               "within_golden_derived_bound": {
                   k: p["max_abs_diff"] <= golden_bound["max"]
                   and p["mean_abs_diff"] <= golden_bound["mean"] for k, p in pixels.items()},
               "cli": cli, "cli_files": n_dec, "cli_s": round(cli_s, 3),
               "cli_streams_equal_runtime": cli_equal, "cli_png_shape": list(png.shape),
               "served": served, "launches": counts, "int8_gemm_launches": int8_launches,
               "bf16_launches": self.bf16_counts["int8"],
               "h_paths": {f"{n}_{k}": v.get("h_path") for n in rts
                           for k, v in {**enc_probes[n], **dec_probes[n]}.items()},
               **timing, "int8_gemm": self._int8_gemm_times()}
        for r in (*rts.values(), rt_bf):
            r.close()
        del rts, rt_bf
        gc.collect()
        torch.cuda.empty_cache()
        float_ok = {"hybrid_codec.encoder.conv_out", "prior_fusion.ffn_fc2"}
        if not (same_weights and all(exact.values())
                and rec["dtypes"] == {"int8_fp32": "float32", "int8_bf16": "bfloat16"}
                and set(rec["quant"].values()) == {"int8"}
                and all(set(v["float_linears"]) == float_ok and v["quant_linears"] > 400
                        for v in layers.values())
                and all(p["rel_norm"] < 0.3 for p in pixels.values())
                and cli["images"] == 2 and n_dec == 2 and cli_equal
                and png.shape == (512, 512, 3) and served["ok"]
                and int8_launches > 0
                and min(counts[k] for k in ("seq_attention", "window_attention_nhwc",
                                            "rans_decode_plane", "rans_encode_plane")) >= 1
                and counts["window_attention"] == 0
                and {p["h_path"] for n in enc_probes for p in enc_probes[n].values()}
                == {"device"}):
            raise AssertionError(f"int8 phase: {rec}")
        return rec

    def _int8_timing(self, rts, rt32, rt_bf, x, requests, reps=5):
        """Request times, median of ``reps``, of the four modes in turns
        (fp32, bf16, int8 in fp32, int8 in bf16), the encode kernel's coder
        on all; one profiled int8+bf16 decode of the 512x512 stream."""
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

        modes = {"fp32": rt32, "bf16": rt_bf, **rts}
        calls = {
            "encode_a_512x512": lambda r: r.encode_only(x["a_512x512"]),
            "encode_group_of_8": lambda r: r.encode_only_batched(x["group_of_8"]),
            "decode_a_512x512": lambda r: r.decode_only(**requests["a_512x512"],
                                                        output="u8")}
        out = {m: {} for m in modes}
        for r in modes.values():
            r.device_entropy = "device"
        try:
            for name, fn in calls.items():
                for m, r in modes.items():
                    out[m][name] = median_ms(lambda: fn(r))
        finally:
            for r in modes.values():
                r.device_entropy = "auto"
        return {"request_ms_p50": out,
                "profile_int8_bf16_decode_512x512": self._profile(
                    lambda: rts["int8_bf16"].decode_only(**requests["a_512x512"],
                                                         output="u8"))}

    def _int8_gemm_times(self):
        """The int8 GEMM (torch._int_mm through ops.quant.int8_mm, weight_q
        (N, K) passed transposed: column-major) at the flagship's Linear
        shapes against F.linear in bf16 and in fp32, CUDA-event and
        CUDA-graph device times; the other operand layout ((K, N)
        row-major) once; the whole QuantLinear against a bf16 Linear (the
        per-row quantization and rescale included).  Bounds at 1,979 int8
        TOPS, 989 bf16 TFLOP/s, 67 f32 TFLOP/s and 3.35 TB/s."""
        import torch.nn.functional as F
        torch = self.torch
        from sic_tpu_torch.models.layers import Linear
        from sic_tpu_torch.ops.quant import QuantLinear, int8_mm, int8_mm_plain
        shapes = {"vit_in_proj": (4 * 289, 1024, 3072),
                  "vit_mlp_fc1": (4 * 289, 1024, 4096),
                  "vit_mlp_fc2": (4 * 289, 4096, 1024),
                  "swin_to_qkv": (32 * 32, 768, 2304),
                  "decoder_embed": (4 * 128, 12, 1024)}
        g = torch.Generator(device="cuda").manual_seed(SEED)
        rows = {}
        for name, (M, K, N) in shapes.items():
            xq = torch.randint(-127, 128, (M, K), device="cuda", generator=g,
                               dtype=torch.int8)
            wq = torch.randint(-127, 128, (N, K), device="cuda", generator=g,
                               dtype=torch.int8)
            w_kn = wq.t().contiguous()
            x32 = torch.randn(M, K, device="cuda", generator=g)
            w32 = torch.randn(N, K, device="cuda", generator=g) * K ** -0.5
            xb, wb = x32.bfloat16(), w32.bfloat16()
            exact = bool(torch.equal(int8_mm(xq, wq), int8_mm_plain(xq, wq)))
            flops = 2.0 * M * N * K
            t_i8 = max(flops / INT8_TOPS, (M * K + N * K + 4 * M * N) / HBM_BYTES_S) * 1e3
            t_bf = max(flops / BF16_TFLOPS, 2 * (M * K + N * K + M * N) / HBM_BYTES_S) * 1e3
            t_32 = max(flops / F32_TFLOPS, 4 * (M * K + N * K + M * N) / HBM_BYTES_S) * 1e3
            lin = Linear(K, N).cuda()
            q = QuantLinear.from_linear(lin)
            lin_bf = Linear(K, N).cuda().bfloat16()
            lin_bf.compute_dtype = torch.bfloat16
            q.compute_dtype = torch.bfloat16
            def device(fn):
                try:
                    return self.device_ms(fn)
                except RuntimeError as e:      # a call the graph cannot capture
                    return f"not measured: {e}"[:200]

            row = {"M": M, "K": K, "N": N, "exact": exact,
                   "int8_ms": self.time_ms(lambda: int8_mm(xq, wq)),
                   "int8_device_ms": device(lambda: int8_mm(xq, wq)),
                   "bf16_ms": self.time_ms(lambda: F.linear(xb, wb)),
                   "bf16_device_ms": device(lambda: F.linear(xb, wb)),
                   "fp32_ms": self.time_ms(lambda: F.linear(x32, w32)),
                   "fp32_device_ms": device(lambda: F.linear(x32, w32)),
                   "quant_linear_bf16_ms": self.time_ms(lambda: q(xb)),
                   "quant_linear_bf16_device_ms": device(lambda: q(xb)),
                   "linear_bf16_ms": self.time_ms(lambda: lin_bf(xb)),
                   "linear_bf16_device_ms": device(lambda: lin_bf(xb)),
                   "int8_bound_ms": t_i8, "bf16_bound_ms": t_bf, "fp32_bound_ms": t_32}
            if K % 8 == 0 and M > 16:
                row["int8_row_major_b_ms"] = self.time_ms(lambda: torch._int_mm(xq, w_kn))
            rows[name] = row
        return rows

    # -- phase 9 ----------------------------------------------------------------
    def _trainer_run(self, **state_kw):
        """The seeded flagship through create_train_state(**state_kw) and
        Trainer at 256 px, batch 2: one epoch (four steps, then an eval
        step) of each stage.  Returns (record, model, state, steps, the
        untimed pix step, train_ds); the caller reads the launch counts."""
        import dataclasses
        import statistics
        import warnings
        torch = self.torch

        from sic_tpu_torch.config import flagship_spec, qp_strategy
        from sic_tpu_torch.data import ImageDataset
        from sic_tpu_torch.train import Trainer, create_train_state
        from sic_tpu_torch.train.state import is_vqgan_decoder_side, named_codec_params
        base = qp_strategy(0, 256)
        strategy = dataclasses.replace(base, stages=tuple(
            dataclasses.replace(st, epoch_num=1) for st in base.stages))
        paths = [HELDOUT / f"val{i}.png" for i in range(8)]
        train_ds = ImageDataset(paths, 256, train=True)
        val_ds = ImageDataset(paths[:2], 256, train=False)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with warnings.catch_warnings():   # uncalibrated LPIPS: no weights here
            warnings.simplefilter("ignore")
            model, state, steps = create_train_state(flagship_spec(), strategy, SEED,
                                                     device="cuda", **state_kw)
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
        dtypes = {"frozen": sorted({str(p.dtype) for p in frozen0.values()}),
                  "trainable": sorted({str(p.dtype) for p in train0.values()})}

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
        disc_moved = sum(not torch.equal(a, b) for a, b in
                         zip(state.disc.parameters(), disc0))
        numbers = [v for d in logs for v in d.values() if isinstance(v, float)]
        finite = all(v == v and abs(v) != float("inf") for v in numbers)
        stages_run = sorted({d["stage"] for d in logs if "stage" in d and "epoch" in d})
        rec = {"spec": "flagship", "init_s": round(init_s, 3),
               "stages_run": stages_run, "steps": {k: len(v) for k, v in step_ms.items()},
               "step_ms_median": {k: statistics.median(v) for k, v in step_ms.items()},
               "step_ms": step_ms, "losses_finite": finite, "log_lines": len(logs),
               "last_logs": logs[-2:], "frozen_leaves": len(frozen0),
               "frozen_bit_unchanged": frozen_equal, "leaf_dtypes": dtypes,
               "trainable_leaves": {"decoder_side": len(decoder_side), "other": len(rest)},
               "after_feat_stages": after_feat, "after_pix": after_pix,
               "disc_leaves_moved": disc_moved,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        rec["ok"] = (finite and frozen_equal and stages_run == ["feat", "feat_wo_bpp", "pix"]
                     and after_feat["decoder_side_moved"] == 0
                     and after_feat["other_trainable_moved"] >= 0.9 * len(rest)
                     and after_pix["decoder_side_moved"] >= 0.9 * len(decoder_side)
                     and disc_moved > 0)
        return rec, model, state, steps, pix_step, train_ds

    def train(self):
        """(a) the seeded flagship through create_train_state and Trainer
        at 256 px, batch 2: one epoch (four steps, then an eval step) of
        each stage; (b) the train CLI at the 512-px preset for one epoch,
        then one image compressed and decompressed with its params."""
        import gc
        torch = self.torch

        from sic_tpu_torch import ops
        shutil.rmtree(TRAIN_WORK, ignore_errors=True)

        # -- the training main path: counts from 0, read after (a) and (b) ---
        ops.reset_launch_counts()
        rec, model, state, steps, pix_step, train_ds = self._trainer_run()
        x = torch.as_tensor(next(train_ds.batches(2, epoch=0)), device="cuda")
        rec["profile_pix_step"] = self._profile(lambda: pix_step(state, x))
        del model, state, steps
        gc.collect()
        torch.cuda.empty_cache()
        rec["cli_512px"] = cli = self._train_cli()
        rec["launches"] = counts = self.read_counts("train")
        # ----------------------------------------------------------------------
        rec["dtype"] = "float32"
        need = ("seq_attention", "window_attention_nhwc", "window_attention_nhwc_bwd")
        if not (rec["ok"] and min(counts[k] for k in need) >= 1 and cli["ok"]):
            raise AssertionError(f"training check failed: {rec}")
        self.train_fp32 = {"step_ms_median": rec["step_ms_median"],
                           "peak_mem_gb": rec["peak_mem_gb"]}
        return rec

    def train_bf16(self):
        """Training as the JAX package trains on an accelerator, with bf16
        compute: phase train's Trainer run with create_train_state(dtype,
        mu_dtype, frozen_dtype all bf16); one pix step with remat against
        the same step without, from one snapshot of the state with the same
        noise; then the train CLI with its CUDA defaults (bf16 moments and
        frozen storage) on tests/fixtures/config_tiny.yaml with --log_dir."""
        import gc
        torch = self.torch
        bf = torch.bfloat16

        from sic_tpu_torch import ops
        from sic_tpu_torch.train import MomentDtypeAdam

        # -- the bf16 training main path: counts from 0, read after the CLI ---
        ops.reset_launch_counts()
        rec, model, state, steps, pix_step, train_ds = self._trainer_run(
            dtype=bf, mu_dtype=bf, frozen_dtype=bf)
        mu_bf16 = isinstance(state.opt_ae, MomentDtypeAdam) and all(
            st["exp_avg"].dtype == bf for st in state.opt_ae.state.values())
        rec["remat"] = remat = self._remat_check(model, state, pix_step, train_ds)
        del model, state, steps
        gc.collect()
        torch.cuda.empty_cache()
        rec["cli_config_tiny"] = cli = self._train_cli_log_dir()
        rec["launches"] = self.read_counts("train_bf16")
        rec["bf16_launches"] = bf16_counts = self.bf16_counts["train_bf16"]
        # ----------------------------------------------------------------------
        rec.update(dtype="bfloat16", mu_dtype="bfloat16", frozen_dtype="bfloat16",
                   adam_mu_bf16=mu_bf16,
                   fp32_beside=getattr(self, "train_fp32", "phase train did not pass"))
        need = ("seq_attention", "window_attention_nhwc", "window_attention_nhwc_bwd")
        ok = (rec["ok"] and mu_bf16
              and rec["leaf_dtypes"] == {"frozen": ["torch.bfloat16"],
                                         "trainable": ["torch.float32"]}
              and min(bf16_counts[k] for k in need) >= 1
              and remat["ok"] and cli["ok"])
        if not ok:
            raise AssertionError(f"bf16 training check failed: {rec}")
        return rec

    def _remat_check(self, model, state, pix_step, train_ds):
        """One pix step with remat against the same step without, each from
        one snapshot of the state, on one batch and one noise draw: losses
        and every trainable gradient.  Equal bit for bit, or, where the step
        itself is not repeatable on the card, no farther apart than two
        runs without remat; peak memory of each."""
        import copy
        torch = self.torch
        hc = model.hybrid_codec
        x = torch.as_tensor(next(train_ds.batches(2, epoch=0)), device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        noise = torch.rand((2, 8, 8, model.spec.quant_dim), device="cuda",
                           generator=gen) - 0.5
        snap = copy.deepcopy(state.state_dict())
        runs = {}
        for tag, flag in (("plain", False), ("remat", True), ("plain_again", False)):
            state.load_state_dict(snap)
            hc.encoder.remat = hc.decoder.remat = flag
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            logs = pix_step(state, x, noise=noise)
            torch.cuda.synchronize()
            # the step's own peak, above what was resident when it began
            # (the state, the snapshot, earlier runs' gradients)
            runs[tag] = {"ms": (time.perf_counter() - t) * 1e3,
                         "step_peak_gb": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                         "logs": logs,
                         "grads": [p.grad.clone() for _, p in state.trainable]}
        hc.encoder.remat = hc.decoder.remat = False
        del snap

        def diff(a, b):
            la = max(abs(float(a["logs"][k]) - float(b["logs"][k])) for k in a["logs"])
            ga = max((u - v).abs().max().item() for u, v in zip(a["grads"], b["grads"]))
            return la, ga

        remat_diff = diff(runs["remat"], runs["plain"])
        repeat_diff = diff(runs["plain_again"], runs["plain"])
        out = {k: {f: v for f, v in r.items() if f in ("ms", "step_peak_gb")}
               for k, r in runs.items()}
        out.update(remat_vs_plain_max_abs={"logs": remat_diff[0], "grads": remat_diff[1]},
                   plain_vs_plain_max_abs={"logs": repeat_diff[0], "grads": repeat_diff[1]},
                   bit_equal=remat_diff == (0.0, 0.0))
        out["ok"] = remat_diff[0] <= repeat_diff[0] and remat_diff[1] <= repeat_diff[1]
        del runs
        return out

    def _train_cli_log_dir(self):
        """The train CLI on CUDA with its defaults (bf16 Adam moments and
        frozen storage, the JAX CLI's accelerator rule) for one epoch of
        tests/fixtures/config_tiny.yaml, with --log_dir: an event file and
        scalars.jsonl."""
        from sic_tpu_torch.cli.train import main as train_main
        log_dir = TRAIN_WORK / "bf16_logs"
        out = train_main(["--base_config", str(ROOT / "tests" / "fixtures" / "config_tiny.yaml"),
                          "--epochs", "1", "--batch_size", "2", "--train_dir", str(HELDOUT),
                          "--ckpt_dir", str(TRAIN_WORK / "bf16_ckpt"), "--log_dir",
                          str(log_dir), "--perceptual", "msssim", "--device", "cuda"])
        events = sorted(p.name for p in log_dir.glob("events.out.tfevents.*"))
        jsonl = log_dir / "scalars.jsonl"
        lines = jsonl.read_text().splitlines() if jsonl.exists() else []
        rec = {"result": out, "event_files": events, "scalars_jsonl_lines": len(lines)}
        rec["ok"] = (out["global_step"] == 4 and out["mu_dtype"] == "torch.bfloat16"
                     and out["frozen_dtype"] == "torch.bfloat16" and len(events) == 1
                     and len(lines) > 0)
        return rec

    def _train_cli(self):
        """The train CLI at the 512-px preset (qp 0: straight into pix),
        one epoch over the heldout images with validation; then one
        512x512 image through the compress and decompress CLIs with its
        deploy_params.npz, and h_hat against the encoder's y_hat."""
        import gc
        torch = self.torch

        from sic_tpu_torch.cli.train import main as train_main
        ckpt = TRAIN_WORK / "ckpt"
        torch.cuda.reset_peak_memory_stats()
        with _reduced_depth(CLI_TRUNK_LAYERS):
            t0 = time.perf_counter()
            out = train_main(["--qp", "0", "--train_px", "512", "--epochs", "1",
                              "--batch_size", "2", "--train_dir", str(HELDOUT),
                              "--val_dir", str(HELDOUT), "--ckpt_dir", str(ckpt),
                              "--device", "cuda"])
            torch.cuda.synchronize()
            rec = {"train_s": round(time.perf_counter() - t0, 3), "result": out,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "files": sorted(p.name for p in ckpt.iterdir()),
                   "last_bytes": (ckpt / "last").stat().st_size,
                   "trunk_layers": CLI_TRUNK_LAYERS}
            gc.collect()
            torch.cuda.empty_cache()
            rec.update(self._deploy_round_trip(ckpt / "deploy_params.npz",
                                               WORK / "encode_in" / "a_512x512.png"))
        rec["ok"] = (out["global_step"] == 4 and "last" in rec["files"]
                     and "deploy_params.npz" in rec["files"] and rec["round_trip_ok"])
        return rec

    def _deploy_round_trip(self, deploy, image):
        return _deploy_round_trip(deploy, image)

    # -- phase 10 ---------------------------------------------------------------
    # -- phase 12 ---------------------------------------------------------------
    def generate(self):
        """TiTok 1-D tokenization and MaskGIT generation at full width,
        seeded: TiTok-L (tile 256) with the MaskGIT-VQGAN pixel decoder, and
        the MaskGIT generator (hidden 768, 24 layers, 16 heads: head dim
        48).  Drives generate (four classes, 8 steps, guidance 3.0) twice
        from one seed, decode_tokens of its ids, TiTok.forward on the eight
        heldout images, forward_latent_concat on the 512x512 mosaic and
        the generate CLI; kernel 1 must launch at head dims 48 and 64.
        Then times (median of 5), one profiled generate and decode_tokens,
        and the card against the CPU."""
        import numpy as np
        torch = self.torch
        from PIL import Image

        from sic_tpu_torch import ops
        from sic_tpu_torch.cli.generate import main as generate_main
        from sic_tpu_torch.config import TiTokSpec
        from sic_tpu_torch.data import load_image
        from sic_tpu_torch.models.maskgit import (MaskGITGenerator, MaskGITSpec,
                                                  generate)
        from sic_tpu_torch.models.maskgit_vqgan import MaskGITVQGANSpec
        from sic_tpu_torch.models.titok import TiTok
        from sic_tpu_torch.weights import init_seeded
        dev = torch.device("cuda")
        t0 = time.perf_counter()
        with torch.device(dev):
            titok = TiTok(TiTokSpec(), MaskGITVQGANSpec())
            gen = MaskGITGenerator(MaskGITSpec(codebook_size=4096, image_seq_len=32))
        init_seeded(titok, seed=0)
        init_seeded(gen, seed=1)
        titok.eval().requires_grad_(False)
        gen.eval().requires_grad_(False)
        init_s = time.perf_counter() - t0
        val = [(load_image(HELDOUT / f"val{i}.png") + 1.0) / 2.0 for i in range(8)]
        x8 = torch.from_numpy(np.stack(val)).to(dev)
        mosaic = torch.from_numpy(np.concatenate(
            [np.concatenate(val[0:2], axis=1), np.concatenate(val[2:4], axis=1)]
        )[None]).to(dev)
        cond = torch.tensor([0, 1, 2, 3], device=dev)
        mask_id = gen.spec.mask_token_id

        def sample(temperature=4.5, model=gen, device=dev):
            out = generate(model, torch.Generator(device=device).manual_seed(SEED),
                           cond.to(device), guidance_scale=3.0,
                           randomize_temperature=temperature, num_sample_steps=8)
            if device.type == "cuda":
                torch.cuda.synchronize()
            return out

        ops.reset_launch_counts()
        ids, ids2 = sample(), sample()
        with torch.no_grad():
            pixels = titok.decode_tokens(ids)
            x_hat, result = titok(x8)
            big, latent = titok.forward_latent_concat(mosaic)
        out_dir = WORK / "generate"
        shutil.rmtree(out_dir, ignore_errors=True)
        t0 = time.perf_counter()
        names = generate_main(["--save_dir", str(out_dir), "--classes", "0,1,2,3"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = self.read_counts("generate")
        by_head_dim = self.head_dim_counts["generate"]
        pngs = [np.asarray(Image.open(out_dir / n)) for n in names]
        # the CLI seeds the same weights and noise: its PNGs are these ids'
        # pixels, if the card repeats itself (reported)
        want = (np.clip(pixels.cpu().numpy(), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        rec = {"init_s": round(init_s, 3), "cli_s": round(cli_s, 3),
               "ids_equal_for_one_seed": torch.equal(ids, ids2),
               "ids_range": [int(ids.min()), int(ids.max())],
               "mask_ids_left": int((ids == mask_id).sum()),
               "pixels_shape": list(pixels.shape),
               "pixels_finite": bool(torch.isfinite(pixels).all()),
               "forward_tokens_shape": list(result["min_encoding_indices"].shape),
               "forward_finite": bool(torch.isfinite(x_hat).all()),
               "latent_concat_shapes": [list(big.shape), list(latent.shape)],
               "latent_concat_finite": bool(torch.isfinite(big).all()
                                            and torch.isfinite(latent).all()),
               "cli_pngs": names, "cli_png_shapes": [list(p.shape) for p in pngs],
               "cli_pngs_equal_in_process": all(
                   p.shape == w.shape and np.array_equal(p, w) for p, w in zip(pngs, want)),
               "launches": counts, "group_norm": self.gn_counts["generate"],
               "seq_attention_launches_by_head_dim": by_head_dim}

        def median_ms(fn, reps=5):
            fn()
            torch.cuda.synchronize()
            t = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                t.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(t))

        with torch.no_grad():
            rec["ms_median_of_5"] = {
                "generate_4_images_8_steps": median_ms(sample),
                "decode_tokens_4": median_ms(lambda: titok.decode_tokens(ids)),
                "forward_8x256x256": median_ms(lambda: titok(x8))}
            rec["profile_generate"] = self._profile(sample)
            rec["profile_decode_tokens_4"] = self._profile(
                lambda: titok.decode_tokens(ids))
        rec["cpu"] = cpu = self._generate_cpu_compare(gen, titok, ids, sample)
        ok = (rec["ids_equal_for_one_seed"] and rec["mask_ids_left"] == 0
              and 0 <= rec["ids_range"][0] and rec["ids_range"][1] < 4096
              and rec["pixels_shape"] == [4, 256, 256, 3] and rec["pixels_finite"]
              and rec["forward_tokens_shape"] == [8, 32] and rec["forward_finite"]
              and rec["latent_concat_shapes"] == [[1, 512, 512, 3], [1, 512, 512, 128]]
              and rec["latent_concat_finite"] and len(names) == 4
              and all(p.shape == (256, 256, 3) for p in pngs)
              and counts["seq_attention"] > 0
              and rec["group_norm"]["composite"] == 0 and rec["group_norm"]["launches"] > 0
              and by_head_dim.get(48, 0) > 0 and by_head_dim.get(64, 0) > 0
              and cpu["logits_rel_diff"] <= GENERATE_CPU_TOL
              and cpu["pixels_rel_diff"] <= GENERATE_CPU_TOL)
        if not ok:
            raise AssertionError(f"generate check failed: {rec}")
        return rec

    def _generate_cpu_compare(self, gen, titok, ids, sample):
        """One generator forward (half the positions masked) and one
        decode_tokens on the card against CPU copies of the same models:
        each within GENERATE_CPU_TOL of the CPU output's largest magnitude
        (and the clipped [0, 1] pixels' largest difference beside it); and
        the ids a temperature-0 sampling differs in between the two,
        reported."""
        import copy
        torch = self.torch
        cpu = torch.device("cpu")
        gen_cpu = copy.deepcopy(gen).to(cpu)
        titok_cpu = copy.deepcopy(titok).to(cpu)
        masked = ids.clone()
        masked[:, ::2] = gen.spec.mask_token_id
        cond = torch.tensor([0, 1, 2, 3])
        drop = torch.tensor([False, False, True, True])
        t0 = time.perf_counter()
        with torch.no_grad():
            lg = gen(masked, cond.to(ids.device), drop.to(ids.device)).cpu()
            lc = gen_cpu(masked.cpu(), cond, drop)
            pg = titok.decode_tokens(ids[:1]).cpu()
            pc = titok_cpu.decode_tokens(ids[:1].cpu())
        cpu_s = time.perf_counter() - t0
        t_card, t_cpu = sample(0.0), sample(0.0, gen_cpu, cpu)
        return {"logits_rel_diff": ((lg - lc).abs().max() / lc.abs().max()).item(),
                "pixels_rel_diff": ((pg - pc).abs().max() / pc.abs().max()).item(),
                "pixels_max_abs": pc.abs().max().item(),
                "clipped_pixels_max_diff": (pg.clamp(0, 1) - pc.clamp(0, 1)).abs().max().item(),
                "temperature_0_ids_differing": int((t_card.cpu() != t_cpu).sum()),
                "cpu_s": round(cpu_s, 3), "bound": GENERATE_CPU_TOL}

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

    # -- phase 15 ---------------------------------------------------------------
    def multiprocess(self):
        """Two ranks on this one card (gloo: ranks sharing a card), started
        as ``python3 chip_smoke.py --rank-task ...`` with WORLD_SIZE, RANK,
        MASTER_ADDR and MASTER_PORT, each driving the port's entry points:
        (1) the compress CLI at world size 2 over the eight heldout 256x256
        images, batch 2, against a one-process compress_dir (every stream
        byte-equal, the merged index equal); (2) one feat step and one pix
        step of the seeded flagship at 256 px over a global batch of two,
        data-parallel (one image a rank) and as a two-stage pipeline (two
        microbatches), each from a fresh state, then (rank 1 idle) the
        one-process steps in rank 0 as references, within PERF.md §2's
        card-vs-CPU training bounds of the reference that runs the rank's
        layer shapes (:func:`_mp_references`), and data parallelism within
        the larger of those bounds and 1.5x that reference's own gap of the
        step as it runs (:func:`_mp_judge`); (3) the train CLI with --pp 2
        --pp_microbatch 2 at 256 px, one step of feat and one of pix, whose
        deploy_params.npz the compress and decompress CLIs load, h_hat
        against the encoder's y_hat; both stages take one batch sequence.  The
        launch counts are those of the ranks' multi-process runs, summed
        (rank 0's one-process references are reported apart)."""
        import gc

        import numpy as np
        torch = self.torch
        from sic_tpu_torch.cli.compress import compress_dir
        from sic_tpu_torch.retrieval import VectorIndex
        shutil.rmtree(MP_WORK, ignore_errors=True)
        shutil.rmtree(TRAIN_WORK, ignore_errors=True)
        src = MP_WORK / "in"
        src.mkdir(parents=True)
        (MP_WORK / "pp_train").mkdir()
        for i in range(8):
            shutil.copy(HELDOUT / f"val{i}.png", src / f"val{i}.png")
            if i < 2:
                shutil.copy(HELDOUT / f"val{i}.png", MP_WORK / "pp_train" / f"val{i}.png")
        t0 = time.perf_counter()
        compress_dir(self.rt, self.clip, src, MP_WORK / "w1", batch_size=2)
        rec = {"compress_world1_s": round(time.perf_counter() - t0, 3)}
        self.rt.close()
        self.rt = self.clip = None
        gc.collect()
        torch.cuda.empty_cache()

        args = ["--dataset_dir", str(src), "--save_dir", str(MP_WORK / "w2"),
                "--spec", "flagship", "--dtype", "float32", "--batch_size", "2"]
        comp = self._run_ranks("compress", args)
        a = sorted((MP_WORK / "w1" / "bitstreams").glob("*.c2df"))
        b = sorted((MP_WORK / "w2" / "bitstreams").glob("*.c2df"))
        idx1, _ = VectorIndex.load(MP_WORK / "w1" / "faiss")
        idx2, _ = VectorIndex.load(MP_WORK / "w2" / "faiss")
        rec["compress"] = {
            "ranks": comp, "streams": len(b),
            "bytes_equal": len(a) == len(b) == 8 and [p.name for p in a] == [p.name for p in b]
            and all(p.read_bytes() == q.read_bytes() for p, q in zip(a, b)),
            "index_equal": bool(np.array_equal(idx1.vectors(), idx2.vectors()))
            and [Path(p).name for p in idx1.ids] == [Path(p).name for p in idx2.ids]}
        train = self._run_ranks("train", [])
        rec["train"] = train
        with _reduced_depth(CLI_TRUNK_LAYERS):   # as the ranks' train CLI ran
            rec["deploy_round_trip"] = trip = self._deploy_round_trip(
                TRAIN_WORK / "pp_ck" / "deploy_params.npz", src / "val0.png")
        # the ranks' launches in their multi-process runs, summed over both
        # tasks of both ranks (rank 0's one-process references apart)
        counts, bf16, by_dim = {}, {}, {}
        for r in comp + train:
            for total, part in ((counts, r["counts"]), (bf16, r["bf16_counts"]),
                                (by_dim, r["head_dim_counts"])):
                for k, n in part.items():
                    total[k] = total.get(k, 0) + n
        self.counts["multiprocess"] = rec["launches"] = counts
        self.bf16_counts["multiprocess"] = bf16
        self.head_dim_counts["multiprocess"] = by_dim
        rec["launches_compress_ranks"] = [r["counts"] for r in comp]
        rec["launches_references"] = train[0]["reference_counts"]
        checks = {
            "compress_bytes_equal": rec["compress"]["bytes_equal"],
            "compress_index_equal": rec["compress"]["index_equal"],
            "compress_kernels": all(r["counts"].get(k, 0) >= 1 for r in comp
                                    for k in ("seq_attention", "window_attention_nhwc")),
            "dp_within_bounds": train[0]["dp"]["ok"],
            "pp_within_bounds": train[0]["pp"]["ok"],
            "train_kernels": all(r["counts"].get(k, 0) >= 1 for r in train
                                 for k in ("seq_attention", "window_attention_nhwc",
                                           "window_attention_nhwc_bwd")),
            "pp_cli": all(r["cli"]["ok"] for r in train) and trip["round_trip_ok"],
            "pp_cli_one_batch_sequence": bool(train[0]["cli"]["batches"])
            and all(r["cli"]["batches"] == train[0]["cli"]["batches"] for r in train)}
        rec["checks"] = checks
        if not all(checks.values()):
            raise AssertionError(f"multiprocess check failed: {checks}")
        shutil.rmtree(TRAIN_WORK, ignore_errors=True)
        return rec

    def _run_ranks(self, task, args, world=2, timeout=900, work=MP_WORK):
        """``task`` on ``world`` rank processes on this card; their JSON
        records and logs in ``work``.  Any rank's failure fails the phase
        (the others are stopped)."""
        import socket
        import os
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = []
        for r in range(world):
            # torchrun's variables; each rank its own string hash salt, so
            # nothing the ranks must agree on may hang on it
            env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(r),
                       LOCAL_WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       PYTHONHASHSEED=str(101 + r))
            log = open(work / f"{task}_rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-task", task,
                 str(work / f"{task}_rank{r}.json"), *args],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log))
        try:
            for p, _ in procs:
                p.wait(timeout=timeout)
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
        if bad:
            tails = {r: (work / f"{task}_rank{r}.log").read_text()[-3000:] for r in bad}
            raise AssertionError(f"{task} ranks {bad} failed: {tails}")
        return [json.loads((work / f"{task}_rank{r}.json").read_text())
                for r in range(world)]

    # -- phase 16 ---------------------------------------------------------------
    def mesh(self):
        """The JAX package's mesh shardings across processes: two ranks on
        this one card (gloo), each ``python3 chip_smoke.py --rank-task
        mesh``, fp32 flagship, seeded: (1) one feat step and one pix step at
        256 px, global batch 2 (val0, val1), data-parallel and under
        ``--fsdp``, equal leaf for leaf, each rank's bytes at rest and peak;
        (2) the same steps at ``--tp 2`` and (3) at ``--tile 2`` on val0 and
        val1 side by side (1 x 256 x 512), each against rank 0's one-process
        step with the ranks' shapes ("split") within PERF.md §2's bounds
        and against the step as it runs within the larger of those bounds
        and 1.5x "split"'s own gap; (4) ``CodecRuntime(mesh=)`` at tile 2
        over val0 and val1, its streams decoding in a one-process runtime
        to its y_hat bit for bit; (5) the train CLI with ``--tp 2`` and with
        ``--fsdp`` (the qp 0 preset cut to one feat and one pix epoch), each
        one's deploy_params.npz through the compress and decompress CLIs.
        Kernels 1, 2 and 5 must launch in every rank of the TP and tile
        runs, kernel 1 at 8 and 6 local heads and kernel 2 (and 5) at 6 and
        8 under TP.  The launches are read around the sharded runs only."""
        shutil.rmtree(MESH_WORK, ignore_errors=True)
        shutil.rmtree(TRAIN_WORK, ignore_errors=True)
        (MESH_WORK / "train").mkdir(parents=True)
        for i in range(2):
            shutil.copy(HELDOUT / f"val{i}.png", MESH_WORK / "train" / f"val{i}.png")
        ranks = self._run_ranks("mesh", [], work=MESH_WORK)
        r0 = ranks[0]
        rec = {"ranks": [{k: v for k, v in r.items() if k not in ("launches", "compare")}
                         for r in ranks],
               "compare": r0.get("compare"),
               "reference_launches": r0.get("reference_launches")}
        counts, bf16, by_dim, by_heads = {}, {}, {}, {}
        for r in ranks:
            for run in r["launches"].values():
                for total, part in ((counts, run["counts"]), (bf16, run["bf16_counts"]),
                                    (by_dim, run["head_dim_counts"])):
                    for k, n in part.items():
                        total[k] = total.get(k, 0) + n
                for k, part in run["heads_counts"].items():
                    for h, n in part.items():
                        by_heads.setdefault(k, {})
                        by_heads[k][h] = by_heads[k].get(h, 0) + n
        self.counts["mesh"] = rec["launches"] = counts
        self.bf16_counts["mesh"] = bf16
        self.head_dim_counts["mesh"] = by_dim
        self.heads_counts["mesh"] = rec["launches_by_heads"] = by_heads
        rec["launches_by_rank_run"] = [r["launches"] for r in ranks]
        kernels = ("seq_attention", "window_attention_nhwc", "window_attention_nhwc_bwd")

        def heads(run, k):
            return set(run["heads_counts"].get(k, {}))

        checks = {
            "fsdp_equals_dp": all(r["fsdp"]["ok"] for r in ranks),
            "tp_within_bounds": bool(r0["compare"]["tp_ok"]),
            "tile_within_bounds": bool(r0["compare"]["tile_ok"]),
            "runtime_decodes": bool(r0["runtime"].get("ok")),
            "kernels_every_tp_and_tile_rank": all(
                r["launches"][run]["counts"].get(k, 0) >= 1
                for r in ranks for run in ("tp", "tile") for k in kernels),
            "tp_local_heads": all(
                {"8", "6"} <= heads(r["launches"]["tp"], "seq_attention")
                and {"6", "8"} <= heads(r["launches"]["tp"], "window_attention_nhwc")
                and {"6", "8"} <= heads(r["launches"]["tp"], "window_attention_nhwc_bwd")
                for r in ranks),
            "cli": all(r["cli_tp"]["ok"] and r["cli_fsdp"]["ok"]
                       and r["round_trip"]["round_trip_ok"] for r in ranks)}
        rec["checks"] = checks
        if not all(checks.values()):
            raise AssertionError(f"mesh check failed: {checks}")
        shutil.rmtree(TRAIN_WORK, ignore_errors=True)
        return rec

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
        from sic_tpu_torch.ops import BF16_ENTRIES
        entries = [(name, entry) for name in names
                   for entry in (("", "_bf16") if name in BF16_ENTRIES else ("",))]
        rows = []
        for name, entry in entries:
            source, replaces = names[name]
            k = self.kernels.get(name + entry, {})
            # launches over the main-path runs (encode, decode, the (G, s,
            # d) op, serving, the surface, bf16 serving, training), of the
            # bf16 entry and of the f32 one apart
            total = sum(c.get(name, 0) for c in self.counts.values())
            bf16 = sum(c.get(name, 0) for c in self.bf16_counts.values())
            rows.append({"name": name + entry, "route": "cuda", "source": source,
                         "dtype": "bfloat16" if entry else "float32",
                         "replaces": replaces,
                         "launches": bf16 if entry else total - bf16,
                         "max_abs_err": k.get("max_abs_err"), "ms": k.get("ms"),
                         "plain_ms": k.get("plain_ms"), "bound_ms": k.get("bound_ms"),
                         "bound_by": k.get("bound_by"),
                         "tc_bound_ms": k.get("tc_bound_ms"),
                         "chain_bound_ms": k.get("chain_bound_ms"),
                         "device_ms": k.get("device_ms"),
                         "library_device_ms": k.get("library_device_ms"),
                         "vs_library": k.get("vs_library"),
                         "deterministic": k.get("deterministic"),
                         "library_ms": k.get("library_ms")})
            if not entry and name in self.heads_counts.get("mesh", {}):
                # the mesh phase's launches by (local) head count
                rows[-1]["launches_by_heads_mesh"] = self.heads_counts["mesh"][name]
            if name + entry == "seq_attention":
                # kernel 1's launches by head dim, both entries together
                by = {}
                for c in self.head_dim_counts.values():
                    for d, n in c.items():
                        by[str(d)] = by.get(str(d), 0) + n
                rows[-1]["launches_by_head_dim"] = by
        # the GroupNorm kernel ports no TPU kernel: its launches and the
        # composite calls (autograd, width slabs) by main-path run; its
        # checks at the flagship's bf16 shape, the f32 one beside
        k, k32 = (self.kernels.get(n, {}) for n in ("group_norm_nhwc", "group_norm_nhwc_f32"))
        rows.append({"name": "group_norm_nhwc", "route": "cuda",
                     "source": "sic_tpu_torch/csrc/group_norm.cu", "dtype": k.get("dtype"),
                     "replaces": None,
                     "launches": sum(c["launches"] for c in self.gn_counts.values()),
                     "composite": sum(c["composite"] for c in self.gn_counts.values()),
                     "by_path": self.gn_counts,
                     **{f: k.get(f) for f in (
                         "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                         "bound_share", "one_pass_bound_ms", "one_pass_bound_share",
                         "device_ms", "library_device_ms", "vs_library", "deterministic",
                         "library_ms")},
                     "f32": {f: k32.get(f) for f in ("shape", "max_abs_err", "ms",
                                                     "device_ms", "bound_ms", "bound_share",
                                                     "library_device_ms", "deterministic")}})
        return {"kernels": rows}


def _deploy_round_trip(deploy, image):
    """``image`` through the compress and decompress CLIs with the params
    ``deploy`` (fp32; one process, whatever the environment's
    ``WORLD_SIZE``), then its decode's h_hat against the encoder's y_hat."""
    import gc
    import torch
    from sic_tpu_torch.cli._common import load_runtime
    from sic_tpu_torch.cli.compress import main as compress_main
    from sic_tpu_torch.cli.decompress import main as decompress_main
    from sic_tpu_torch.config import flagship_spec
    from sic_tpu_torch.data import load_image
    work = deploy.parent / "round_trip"
    src = work / "in"
    src.mkdir(parents=True, exist_ok=True)
    shutil.copy(image, src / image.name)
    common = ["--ckpt_path", str(deploy), "--spec", "flagship", "--device", "cuda",
              "--dtype", "float32"]
    t0 = time.perf_counter()
    compress_main(["--dataset_dir", str(src), "--save_dir", str(work / "c"),
                   "--world_size", "1", "--rank", "0", *common])
    n_dec = decompress_main(["--dataset_dir", str(work / "c" / "bitstreams"),
                             "--save_dir", str(work / "d"), *common])
    rec = {"cli_round_trip_s": round(time.perf_counter() - t0, 3)}
    rt = load_runtime(str(deploy), flagship_spec(), device="cuda", stream_part=4,
                      dtype="float32")
    probe, dec = {}, {}
    enc = rt.encode_only(load_image(src / image.name)[None], probe=probe)
    rt.decode_only(**enc, coding_batch=8, probe=dec)
    rt.close()
    rec["h_hat_equal_y_hat"] = bool(torch.equal(dec["h_hat"], probe["y_hat"]))
    rec["decoded_files"] = n_dec
    rec["round_trip_ok"] = n_dec == 1 and rec["h_hat_equal_y_hat"]
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# -- the multiprocess phase's rank processes ------------------------------------

def _mp_batch():
    """The global batch of the multiprocess phase's training checks: heldout
    val0 and val1, center-cropped at 256 px, in [-1, 1]."""
    from sic_tpu_torch.data import ImageDataset
    return next(ImageDataset([HELDOUT / "val0.png", HELDOUT / "val1.png"], 256,
                             train=False).batches(2))


def _mp_state(device, data=None, pp=None):
    """The seeded flagship's fp32 training state at the 256-px qp 0 preset
    (uncalibrated LPIPS: no VGG16 weights here)."""
    import warnings
    from sic_tpu_torch.config import flagship_spec, qp_strategy
    from sic_tpu_torch.train import create_train_state
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, state, steps = create_train_state(flagship_spec(), qp_strategy(0, 256), SEED,
                                             device=device, data=data, pp=pp)
    return state, steps


def _mp_stages(state):
    """Yield "feat", then "pix" with ``state`` back at its initial trainable
    parameters, generator and optimizer: each step as from a fresh state
    (a feat step leaves the discriminator as it was)."""
    import torch
    snap = [p.detach().to("cpu", copy=True) for _, p in state.trainable]
    gen = state.generator.get_state()
    yield "feat"
    with torch.no_grad():
        for (_, p), s in zip(state.trainable, snap):
            p.copy_(s)
    state.generator.set_state(gen)
    state.opt_ae.state.clear()
    state.global_step = 0
    yield "pix"
    with torch.no_grad():
        for (_, p), s in zip(state.trainable, snap):
            p.copy_(s)
    state.generator.set_state(gen)
    state.opt_ae.state.clear()
    state.global_step = 0


def _mp_reset_disc(state):
    """The discriminator back at its seeded weights and statistics, its
    optimizer fresh."""
    import torch
    state.disc.init_weights(torch.Generator(state.device).manual_seed(SEED + 1))
    for n, b in state.disc.named_buffers():
        b.fill_(1.0 if n.endswith("var") else 0.0)
    state.disc.zero_grad(set_to_none=True)
    state.opt_disc.state.clear()


@contextlib.contextmanager
def _per_rank_shapes(modules, parts):
    """Run every Linear and convolution of ``modules`` (and the pix step's
    re-applied last convolution) on ``parts`` equal chunks of its input's
    leading (batch) dim in turn, concatenated: a data-parallel rank's
    shapes, under which cuBLAS and cuDNN pick the kernels the ranks pick.
    The same function; ``parts`` 1 changes nothing."""
    import torch
    from torch import nn
    from sic_tpu_torch.train import steps as steps_mod
    if parts == 1:
        yield
        return
    patched = []
    for root in modules:
        for m in root.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.forward = functools.partial(_chunked, m.forward, parts)
                patched.append(m)
    last = steps_mod._last_conv_apply
    steps_mod._last_conv_apply = lambda h, w, b: torch.cat(
        [last(c, w, b) for c in h.chunk(parts)])
    try:
        yield
    finally:
        for m in patched:
            del m.forward
        steps_mod._last_conv_apply = last


def _chunked(forward, parts, x, *args, **kwargs):
    import torch
    return torch.cat([forward(c, *args, **kwargs) for c in x.chunk(parts)])


def _mp_grads(state, keep="cpu"):
    """Copies on ``keep``: the trainable leaves' gradients by JAX key, the
    discriminator's by name, and its batch statistics."""
    import torch

    def host(t):
        return t.detach().to(keep, torch.float32, copy=True)
    out = {"/".join(path): host(p.grad) for path, p in state.trainable}
    out.update({"disc." + n: host(p.grad)
                for n, p in state.disc.named_parameters() if p.grad is not None})
    out.update({"stats." + n: host(b) for n, b in state.disc.named_buffers()})
    return out


def _mp_run_steps(state, steps, x, shapes=1, keep="cpu"):
    """A feat step, then a pix step from the same initial state: each
    one's time, logs and gradients (copies on ``keep``); ``shapes`` 2 runs
    every Linear and convolution on a data-parallel rank's shapes."""
    import torch
    out = {}
    for stage in _mp_stages(state):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with _per_rank_shapes((state.model, state.disc, state.lpips), shapes):
            logs = getattr(steps, f"{stage}_step")(state, x)
        torch.cuda.synchronize()
        out[stage] = {"step_ms": (time.perf_counter() - t) * 1e3,
                      "logs": {k: float(v) for k, v in logs.items()},
                      "grads": _mp_grads(state, keep)}
    return out


def _mp_errors(got, ref, stage, device):
    """One step's logs and gradients against a reference step's (on
    ``device``): the largest loss error (relative), leaf error (past the
    floor of 1e-6 of the whole gradient's norm, relative to the leaf's
    norm) and statistics error (relative to the largest), and whether they
    lie within PERF.md §2's card-vs-CPU training bounds."""
    import torch
    loss = max(abs(got["logs"][k] - v) / abs(v) for k, v in ref["logs"].items()
               if abs(v) > 1e-6)
    norm = float(torch.sqrt(sum(g.double().square().sum()
                                for k, g in ref["grads"].items()
                                if not k.startswith("stats."))))
    leaf, stats, worst = 0.0, 0.0, None
    for k, g in got["grads"].items():
        a = g.to(device, torch.float64)
        want = ref["grads"][k].to(device, torch.float64)
        if k.startswith("stats."):
            stats = max(stats, float((a - want).abs().max()
                                     / want.abs().max().clamp_min(1e-30)))
            continue
        err = (float((a - want).norm()) - 1e-6 * norm) / max(float(want.norm()), 1e-30)
        if err > leaf:
            leaf, worst = err, k
    loss_tol, grad_tol = ((TRAIN_LOSS_TOL, TRAIN_GRAD_TOL) if stage == "feat"
                          else (PIX_LOSS_TOL, PIX_GRAD_TOL))
    return {"max_loss_rel_err": loss, "max_leaf_grad_rel_err": leaf, "worst_leaf": worst,
            "stats_rel_err": stats, "leaves": len(got["grads"]),
            "ok": loss <= loss_tol and leaf <= grad_tol and stats <= loss_tol}


def _mp_rank_steps(device, x, data=None, pp=None):
    """This rank's feat and pix steps (``data``: its rows of the global
    batch; ``pp``: its pipeline stage), each from a fresh state.  Returns
    (record, results): the results, on rank 0 only, hold the whole
    model's gradients (a pipeline's stage 1 sends its cells' to rank 0,
    and the norms of its other leaves, which must equal stage 0's)."""
    import gc
    import torch
    from sic_tpu_torch.models.hybrid import is_cell_leaf
    from sic_tpu_torch.parallel import gather_to_first
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, steps = _mp_state(device, data, pp)
    rec = {"init_s": round(time.perf_counter() - t0, 3)}
    # the steps' gradient all-reduces, timed on the host's clock
    from sic_tpu_torch.parallel import multihost
    reduce, spent = multihost.reduce_grads, []

    def timed_reduce(params, group):
        params = list(params)
        if group is None:
            return
        torch.cuda.synchronize()
        t = time.perf_counter()
        reduce(params, group)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)

    multihost.reduce_grads = timed_reduce
    try:
        res = _mp_run_steps(state, steps, torch.as_tensor(x, device=device))
    finally:
        multihost.reduce_grads = reduce
    rec.update({f"{stage}_step_ms": r["step_ms"] for stage, r in res.items()})
    # feat: one all-reduce (the codec's); pix: the codec's, then the
    # discriminator's
    rec["allreduce_s"] = spent
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    rank = data.index if data is not None else pp.stage
    if pp is not None:
        for stage, r in res.items():
            mine = {k: g for k, g in r["grads"].items() if is_cell_leaf(k)}
            rest = {k: float(g.double().norm()) for k, g in r["grads"].items()
                    if not is_cell_leaf(k)}
            parts = gather_to_first((mine, rest), pp.group)
            if parts is not None:
                r["grads"].update(parts[1][0])
                other = parts[1][1]
                rec[f"{stage}_replicated_norm_rel_diff"] = max(
                    abs(other[k] - v) / max(v, 1e-30) for k, v in rest.items())
    del state, steps
    gc.collect()
    torch.cuda.empty_cache()
    return rec, (res if rank == 0 else None)


def _mp_references(device, x):
    """Rank 0's one-process references of the global batch: the steps as
    they run ("global"), and with every Linear and convolution on the two
    ranks' halves of its batch in turn ("split": cuBLAS and cuDNN pick
    other kernels at another batch size, and their sums differ)."""
    import gc
    import torch
    torch.cuda.reset_peak_memory_stats()
    state, steps = _mp_state(device)
    xt = torch.as_tensor(x, device=device)
    refs = {}
    for name, shapes in (("global", 1), ("split", 2)):
        refs[name] = _mp_run_steps(state, steps, xt, shapes, keep=device)
        _mp_reset_disc(state)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, steps
    gc.collect()
    torch.cuda.empty_cache()
    return refs, peak


def _mp_judge(dp, pp, refs, device):
    """Every comparison of the ranks' steps with the references.  Data
    parallelism is judged against "split", whose layers run the ranks'
    shapes, within PERF.md §2's bounds, and against "global" within the
    larger of those bounds and 1.5x "split"'s own gap to "global" (the
    card's spread between the two shapes); the pipeline against "global"
    (its replicated layers run the whole batch, its trunk cells
    microbatches).  The references'
    gradients are on the card; the ranks' are moved there."""
    for res in (dp, pp):
        for r in res.values():
            r["grads"] = {k: g.to(device) for k, g in r["grads"].items()}
    rec = {}
    for stage in ("feat", "pix"):
        for who, res in (("dp", dp), ("pp", pp)):
            for ref in ("global", "split"):
                rec[f"{who}_vs_{ref}_{stage}"] = _mp_errors(res[stage], refs[ref][stage],
                                                            stage, device)
        rec[f"split_vs_global_{stage}"] = _mp_errors(refs["split"][stage],
                                                     refs["global"][stage], stage, device)
        # data parallelism against the step as it runs: no farther than
        # the bounds or 1.5x the split's own gap, whichever is larger
        gap, got = rec[f"split_vs_global_{stage}"], rec[f"dp_vs_global_{stage}"]
        loss_tol, grad_tol = ((TRAIN_LOSS_TOL, TRAIN_GRAD_TOL) if stage == "feat"
                              else (PIX_LOSS_TOL, PIX_GRAD_TOL))
        limits = {"max_loss_rel_err": max(loss_tol, 1.5 * gap["max_loss_rel_err"]),
                  "max_leaf_grad_rel_err": max(grad_tol,
                                               1.5 * gap["max_leaf_grad_rel_err"]),
                  "stats_rel_err": max(loss_tol, 1.5 * gap["stats_rel_err"])}
        rec[f"dp_vs_global_{stage}_limits"] = limits
        rec[f"dp_vs_global_{stage}_ok"] = all(got[k] <= v for k, v in limits.items())
    rec["dp_ok"] = all(rec[f"dp_vs_split_{s}"]["ok"] and rec[f"dp_vs_global_{s}_ok"]
                       for s in ("feat", "pix"))
    rec["pp_ok"] = all(rec[f"pp_vs_global_{s}"]["ok"] for s in ("feat", "pix"))
    return rec


def _rank_pp_cli(rank):
    """The train CLI with --pp 2 --pp_microbatch 2 at 256 px over val0 and
    val1: the qp 0 preset cut to one epoch of feat, then one of pix."""
    import dataclasses
    import torch
    from sic_tpu_torch import config
    from sic_tpu_torch.cli.train import main as train_main
    from sic_tpu_torch.train.trainer import Trainer
    base = config.qp_strategy(0, 256)
    cut = dataclasses.replace(base, stages=tuple(
        dataclasses.replace(st, epoch_num=n) for st, n in zip(base.stages, (0, 1, 1))))
    config.qp_strategy = lambda qp=0, train_px=256: cut
    ckpt = TRAIN_WORK / "pp_ck"
    # the digest of every global batch the trainer takes: one sequence on
    # both stages (the last stage's loss reads its own x)
    seen, take = [], Trainer._batch

    def recording(self, batch):
        import hashlib
        import numpy as np
        seen.append(hashlib.sha256(np.ascontiguousarray(batch, np.float32)).hexdigest())
        return take(self, batch)

    Trainer._batch = recording
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _reduced_depth(CLI_TRUNK_LAYERS):
        out = train_main(["--qp", "0", "--train_px", "256", "--epochs", "2",
                          "--batch_size", "2", "--train_dir", str(MP_WORK / "pp_train"),
                          "--ckpt_dir", str(ckpt), "--pp", "2", "--pp_microbatch", "2"])
    Trainer._batch = take
    rec = {"train_s": round(time.perf_counter() - t0, 3), "result": out,
           "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30, "batches": seen}
    if rank == 0:
        rec["files"] = sorted(p.name for p in ckpt.iterdir())
    rec["ok"] = out["global_step"] == 2 and out["pp"] == 2 and (
        rank != 0 or {"last", "deploy_params.npz", "feat_epo_for_strategy_0"}
        <= set(rec["files"]))
    return rec


def _rank_train(args):
    import gc
    import os
    import torch
    from sic_tpu_torch.models.hybrid import PPConfig
    from sic_tpu_torch.parallel import (barrier, grid_groups, rank_device,
                                        setup_distributed, take_rows)
    rank, world = setup_distributed(device=rank_device(int(os.environ["RANK"])))
    device = rank_device(rank)
    x = _mp_batch()
    data, _ = grid_groups(1)
    rec = {"rank": rank}
    rec["dp"], dp = _mp_rank_steps(device, take_rows(x, data), data=data)
    _, pipe = grid_groups(world)
    rec["pp"], pp = _mp_rank_steps(device, x, pp=PPConfig(pipe, 2))
    barrier("ranks_done")
    steps_launches = _rank_launches()
    if rank == 0:          # the one-process references, rank 1 idle
        refs, rec["reference_peak_gb"] = _mp_references(device, x)
        rec["reference_step_ms"] = {f"{name}_{stage}": r[stage]["step_ms"]
                                    for name, r in refs.items() for stage in r}
        rec["compare"] = cmp = _mp_judge(dp, pp, refs, device)
        # the pipeline's replicated leaves: the same on both stages
        rec["dp"]["ok"], rec["pp"]["ok"] = cmp["dp_ok"], cmp["pp_ok"] and all(
            rec["pp"][f"{s}_replicated_norm_rel_diff"] <= TRAIN_GRAD_TOL
            for s in ("feat", "pix"))
        del refs
    del dp, pp
    gc.collect()
    torch.cuda.empty_cache()
    barrier("references_done")
    rec["reference_counts"] = _rank_launches()["counts"]    # not the path's
    rec["cli"] = _rank_pp_cli(rank)
    rec.update(_rank_launches(steps_launches))
    return rec


def _rank_compress(args):
    import torch
    from sic_tpu_torch.cli.compress import main as compress_main
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = compress_main(args)
    return {"result": out, "seconds": round(time.perf_counter() - t0, 3),
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30, **_rank_launches()}


def _rank_launches(before=None):
    """The launch counts since the last reset (``counts``, ``bf16_counts``,
    ``head_dim_counts``), added to ``before``'s; the counters reset."""
    from sic_tpu_torch import ops
    now = {"counts": ops.launch_counts(), "bf16_counts": ops.bf16_launch_counts(),
           "head_dim_counts": {str(k): v
                               for k, v in ops.head_dim_launch_counts().items()}}
    ops.reset_launch_counts()
    for view, part in (before or {}).items():
        for k, n in part.items():
            now[view][k] = now[view].get(k, 0) + n
    return now


# -- the mesh phase's rank processes ---------------------------------------------

def _mesh_wide(x):
    """val0 and val1 side by side: the (1, 256, 512, 3) image of the width
    split's steps (two 256-px tiles, one a rank)."""
    import numpy as np
    return np.concatenate([x[0:1], x[1:2]], axis=2)


def _mesh_record(state, keep, whole=True):
    """The trainable leaves' gradients and the discriminator's, copies on
    ``keep``, by name: in the one-process layout (a split leaf gathered
    through the state's layout, a collective), or with ``whole`` False as
    the rank holds them, beside ``fsdp_dims``, the dim of each FSDP
    chunk."""
    import torch
    layout = state.layout
    names = {id(p): "model." + n for n, p in state.model.named_parameters()}
    names.update({id(p): "disc." + n for n, p in state.disc.named_parameters()})
    params = [("/".join(path), p) for path, p in state.trainable] + [
        ("disc." + n, p) for n, p in state.disc.named_parameters() if p.grad is not None]
    out, dims = {}, {}
    for key, p in params:
        g, name = p.grad.detach(), names[id(p)]
        if layout and name in layout.fsdp:
            dims[key] = layout.fsdp[name]
        if whole and layout and (name in layout.tp or name in layout.fsdp):
            g = layout.full(name, g)
        out[key] = g.to(keep, torch.float32, copy=True)
    out.update({"stats." + n: b.detach().to(keep, torch.float32, copy=True)
                for n, b in state.disc.named_buffers()})
    return out, dims


def _mesh_steps(device, mesh, x, fsdp=False, keep="cpu", whole=True):
    """A feat step and a pix step, each from a fresh seeded flagship state
    on ``mesh``: times, logs, gradients (on ``keep``; see
    :func:`_mesh_record`), and the rank's bytes at rest and peak."""
    import gc
    import torch
    from sic_tpu_torch.parallel import shard_batch, state_bytes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    xl = torch.as_tensor(shard_batch(x, mesh), device=device)
    for stage in ("feat", "pix"):
        t0 = time.perf_counter()
        state, steps = _mp_state_mesh(device, mesh, fsdp)
        init_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t = time.perf_counter()
        logs = getattr(steps, f"{stage}_step")(state, xl)
        torch.cuda.synchronize()
        out[stage] = {"step_ms": (time.perf_counter() - t) * 1e3,
                      "init_s": round(init_s, 3),
                      "logs": {k: float(v) for k, v in logs.items()},
                      "bytes_at_rest": state_bytes([state.model, state.disc],
                                                   [state.opt_ae, state.opt_disc]),
                      # the FSDP chunks' bytes (parameters and moments)
                      "chunk_bytes": sum(
                          t.numel() * t.element_size() for f in state.fsdp.values()
                          for _, p, _ in f.leaves
                          for t in [p] + [v for opt in (state.opt_ae, state.opt_disc)
                                          for v in opt.state.get(p, {}).values()
                                          if isinstance(v, torch.Tensor) and v.dim()])}
        out[stage]["grads"], out[stage]["fsdp_dims"] = _mesh_record(state, keep, whole)
        del state, steps
        gc.collect()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    return out, peak


def _mp_state_mesh(device, mesh, fsdp):
    import warnings
    from sic_tpu_torch.config import flagship_spec, qp_strategy
    from sic_tpu_torch.train import create_train_state
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, state, steps = create_train_state(flagship_spec(), qp_strategy(0, 256), SEED,
                                             device=device, mesh=mesh, fsdp=fsdp)
    return state, steps


def _mesh_fsdp(device, grid, x):
    """FSDP against data parallelism at world 2: this rank's chunk of each
    planned leaf's gradient equal to the same chunk of the DP step's, and
    the unplanned leaves' equal; bytes at rest and peaks."""
    import torch
    from sic_tpu_torch.parallel import make_mesh
    from sic_tpu_torch.parallel.collectives import chunk_of
    mesh = make_mesh((2, 1, 1), grid)
    # each FSDP chunk against the same chunk of the DP step's gradient (the
    # records on the host, out of the peaks)
    dp, dp_peak = _mesh_steps(device, mesh, x)
    fs, fs_peak = _mesh_steps(device, mesh, x, fsdp=True, whole=False)
    rec = {"dp_peak_gb": dp_peak, "fsdp_peak_gb": fs_peak}
    for stage in ("feat", "pix"):
        a, b = fs[stage], dp[stage]
        dims = a["fsdp_dims"]
        rec[f"{stage}_planned_leaves"] = len(dims)
        rec[f"{stage}_logs_equal"] = a["logs"] == b["logs"]
        rec[f"{stage}_grads_equal"] = set(a["grads"]) == set(b["grads"]) and all(
            torch.equal(g, b["grads"][k] if k not in dims
                        else chunk_of(b["grads"][k], mesh.data, dims[k]))
            for k, g in a["grads"].items())
        rec[f"{stage}_step_ms"] = {"fsdp": a["step_ms"], "dp": b["step_ms"]}
        rec[f"{stage}_bytes_at_rest"] = {"fsdp": a["bytes_at_rest"], "dp": b["bytes_at_rest"]}
        # at rest: half of each planned leaf (and of its moments), the rest
        # whole: the DP state's bytes less one chunk of each planned leaf
        rec[f"{stage}_at_rest_as_planned"] = \
            a["bytes_at_rest"] == b["bytes_at_rest"] - a["chunk_bytes"]
    rec["ok"] = all(rec[f"{s}_{k}"] for s in ("feat", "pix")
                    for k in ("logs_equal", "grads_equal", "at_rest_as_planned"))
    return rec


def _mesh_runtime(device, grid):
    """``CodecRuntime(mesh=)`` at tile 2 over val0 and val1: both ranks get
    the same streams; rank 0 decodes them in a one-process runtime, h_hat
    against the mesh runtime's y_hat, bit for bit."""
    import gc
    import torch
    from sic_tpu_torch.config import flagship_spec
    from sic_tpu_torch.models import Codec, CodecRuntime
    from sic_tpu_torch.parallel import gather_to_first, make_mesh
    from sic_tpu_torch.weights import init_seeded
    mesh = make_mesh((1, 2), ("data", "tile"))
    x = _mp_batch()
    with torch.device(device):
        model = Codec(flagship_spec())
    init_seeded(model, SEED)
    rt = CodecRuntime(flagship_spec(), model, mesh=mesh, stream_part=4)
    probe = {}
    _mesh_launches()
    t0 = time.perf_counter()
    encs = rt.encode_only_batched(x, probe=probe)
    rec = {"encode_s": round(time.perf_counter() - t0, 3), "h_path": probe["h_path"],
           "paths": dict(rt.encode_path_counts), "launches": _mesh_launches()}
    rt.close()
    streams = [e["h_bit_stream"] + e["z_bit_stream"] for e in encs]
    every = gather_to_first(streams, mesh.tile)
    if every is not None:
        one = CodecRuntime(flagship_spec(), model, stream_part=4)
        dec = {}
        one.decode_only_batched(encs, probe=dec)
        one.close()
        rec["reference_launches"] = _mesh_launches()    # the check's, not the path's
        rec["streams_equal_on_ranks"] = all(s == every[0] for s in every)
        rec["h_hat_equal_y_hat"] = bool(torch.equal(dec["h_hat"], probe["y_hat"]))
        rec["ok"] = rec["streams_equal_on_ranks"] and rec["h_hat_equal_y_hat"] \
            and rec["h_path"] == "host"
    del rt, model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


@contextlib.contextmanager
def _tp_split_shapes(model, n=2):
    """Every Linear the TP plan splits runs as the ``n`` ranks run it, in
    one process: a column projection as the ranks' row blocks (of each of
    q, k, v) side by side, a row projection as the ranks' partial products
    summed, then the bias.  The same function; the ranks' shapes."""
    import torch
    import torch.nn.functional as F
    from sic_tpu_torch.parallel.mesh import _tp_split, _tp_units
    from sic_tpu_torch.parallel.multihost import Group
    ranks = [Group(None, tuple(range(n)), r) for r in range(n)]
    patched = []

    def column(lin, parts, x):
        w, b = lin.weight, lin.bias
        ys = [F.linear(x, _tp_split(w, 0, parts, g),
                       None if b is None else _tp_split(b, 0, parts, g)) for g in ranks]
        k = ys[0].shape[-1] // parts
        return torch.stack([y.unflatten(-1, (parts, k)) for y in ys], -2).flatten(-3)

    def row(lin, x):
        w, k = lin.weight, lin.weight.shape[1] // n
        y = sum(F.linear(x[..., r * k:(r + 1) * k], w[:, r * k:(r + 1) * k])
                for r in range(n))
        return y if lin.bias is None else y + lin.bias

    for _, mod, col, rw, parts, _ in _tp_units(model, n):
        c, r = getattr(mod, col), getattr(mod, rw)
        c.forward = functools.partial(column, c, parts)
        r.forward = functools.partial(row, r)
        patched += [c, r]
    try:
        yield
    finally:
        for m in patched:
            del m.forward


@contextlib.contextmanager
def _tile_split_shapes(modules, n=2):
    """Every convolution and pointwise Linear of ``modules`` outside the
    gathered regions (the bottleneck, the discriminator) runs as the ``n``
    width slabs' ranks run it, in one process: each slab with its halo
    (zeros past the image's edges), the results side by side; tokens of
    whole tiles in the ranks' tile groups.  The same function; the ranks'
    shapes."""
    import torch
    import torch.nn.functional as F
    from torch import nn
    from sic_tpu_torch.models import layers, vqgan
    from sic_tpu_torch.models.bottleneck import CompressiveBottleneck
    from sic_tpu_torch.train import steps as steps_mod

    def halves(x, left, right):
        W = x.shape[2] // n
        pad = F.pad(x, (0, 0, left, right))
        return [pad[:, :, r * W:(r + 1) * W + left + right] for r in range(n)]

    def conv(m, x):
        kw, sw = m.kernel_size[1], m.stride[1]
        if m.kernel_size == (1, 1) and m.stride == (1, 1) and m.groups == 1:
            return pointwise(m, x)
        if sw == 1:
            p = kw // 2
            return torch.cat([m.conv_local(h, padding=(m.padding[0], 0))
                              for h in halves(x, p, p)], 2)
        return torch.cat([m.conv_local(h) for h in halves(x, 0, 0)], 2)

    def pointwise(m, x):
        if x.dim() == 4:
            W = x.shape[2] // n
            return torch.cat([m.__class__.forward(m, x[:, :, r * W:(r + 1) * W].contiguous())
                              for r in range(n)], 2)
        if x.dim() == 3 and x.shape[0] % n == 0:
            return torch.cat([m.__class__.forward(m, c.contiguous()) for c in x.chunk(n)])
        return m.__class__.forward(m, x)

    def down(m, x):
        x = F.pad(x, (0, 0, 0, 0, 0, 1))
        return torch.cat([m.conv.conv_local(h) for h in halves(x, 0, 1)], 2)

    def group_norm(m, x):
        # the ranks' two passes, each slab's sums added as the all-reduce adds
        B, H, W, C = x.shape
        G = m.num_groups
        xs = [h.float().reshape(B, H, W // n, G, C // G) for h in halves(x, 0, 0)]
        cnt = H * W * (C // G)
        mean = sum(h.sum(dim=(1, 2, 4)) for h in xs) / cnt
        ds = [h - mean[:, None, None, :, None] for h in xs]
        var = sum((d * d).sum(dim=(1, 2, 4)) for d in ds) / cnt
        inv = torch.rsqrt(var + m.eps)[:, None, None, :, None]
        y = torch.cat([(d * inv).reshape(B, H, W // n, C) for d in ds], 2)
        y = (y * m.weight.float() + m.bias.float()).to(x.dtype)
        return F.silu(y) if m.silu else y

    skip = set()
    for root in modules:
        for mod in root.modules():
            if isinstance(mod, CompressiveBottleneck) or mod.__class__.__name__ == "NLayerDiscriminator":
                skip |= {id(m) for m in mod.modules()}
    patched = []
    for root in modules:
        for m in root.modules():
            if id(m) in skip:
                continue
            if isinstance(m, layers.Conv2d):
                m.forward = functools.partial(conv, m)
            elif isinstance(m, nn.Linear):
                m.forward = functools.partial(pointwise, m)
            elif isinstance(m, vqgan.Downsample):
                m.forward = functools.partial(down, m)
            elif isinstance(m, layers.GroupNorm):
                m.forward = functools.partial(group_norm, m)
            else:
                continue
            patched.append(m)
    last = steps_mod._last_conv_apply
    steps_mod._last_conv_apply = lambda h, w, b: torch.cat(
        [F.conv2d(c.permute(0, 3, 1, 2), w, b, padding=(1, 0)).permute(0, 2, 3, 1)
         for c in halves(h.to(w.dtype), 1, 1)], 2)
    try:
        yield
    finally:
        for m in patched:
            del m.forward
        steps_mod._last_conv_apply = last


def _mesh_references(device, x, wide):
    """Rank 0's one-process references: the steps as they run ("global")
    and with the ranks' shapes ("split"), for TP on the 256-px batch and
    for the width split on the 512-px-wide image."""
    import gc
    import torch
    state, steps = _mp_state(device)
    refs = {}
    for name, xs in (("tp", x), ("tile", wide)):
        xt = torch.as_tensor(xs, device=device)
        for kind in ("global", "split"):
            ctx = (contextlib.nullcontext() if kind == "global" else
                   _tp_split_shapes(state.model) if name == "tp" else
                   _tile_split_shapes((state.model, state.lpips)))
            with ctx:
                refs[f"{name}_{kind}"] = _mp_run_steps(state, steps, xt, keep=device)
            _mp_reset_disc(state)
    del state, steps
    gc.collect()
    torch.cuda.empty_cache()
    return refs


def _mesh_judge(runs, refs, device):
    """TP and the width split against their "split" references within
    PERF.md §2's bounds, and against "global" within the larger of those
    bounds and 1.5x "split"'s own gap to "global"."""
    rec = {}
    for name in ("tp", "tile"):
        for r in runs[name].values():
            r["grads"] = {k: g.to(device) for k, g in r["grads"].items()}
        for stage in ("feat", "pix"):
            got = runs[name][stage]
            split, glob = refs[f"{name}_split"][stage], refs[f"{name}_global"][stage]
            rec[f"{name}_vs_split_{stage}"] = _mp_errors(got, split, stage, device)
            gap = rec[f"split_vs_global_{name}_{stage}"] = _mp_errors(split, glob, stage, device)
            g = rec[f"{name}_vs_global_{stage}"] = _mp_errors(got, glob, stage, device)
            loss_tol, grad_tol = ((TRAIN_LOSS_TOL, TRAIN_GRAD_TOL) if stage == "feat"
                                  else (PIX_LOSS_TOL, PIX_GRAD_TOL))
            limits = {"max_loss_rel_err": max(loss_tol, 1.5 * gap["max_loss_rel_err"]),
                      "max_leaf_grad_rel_err": max(grad_tol, 1.5 * gap["max_leaf_grad_rel_err"]),
                      "stats_rel_err": max(loss_tol, 1.5 * gap["stats_rel_err"])}
            rec[f"{name}_vs_global_{stage}_limits"] = limits
            rec[f"{name}_vs_global_{stage}_ok"] = all(g[k] <= v for k, v in limits.items())
        rec[f"{name}_ok"] = all(rec[f"{name}_vs_split_{s}"]["ok"]
                                and rec[f"{name}_vs_global_{s}_ok"] for s in ("feat", "pix"))
    return rec


def _mesh_cli(flags, ckpt_name, last=False):
    """The train CLI with ``flags`` at world size 2 at 256 px over val0 and
    val1 (the qp 0 preset cut to one feat epoch and one pix epoch); the
    process group is kept for the next run unless ``last``."""
    import dataclasses
    import torch
    from sic_tpu_torch import config, parallel
    from sic_tpu_torch.cli.train import main as train_main
    base = config.qp_strategy(0, 256)
    cut = dataclasses.replace(base, stages=tuple(
        dataclasses.replace(st, epoch_num=k) for st, k in zip(base.stages, (0, 1, 1))))
    keep = config.qp_strategy, parallel.shutdown
    config.qp_strategy = lambda qp=0, train_px=256: cut
    if not last:
        parallel.shutdown = lambda: None
    ckpt = TRAIN_WORK / ckpt_name
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = train_main(["--qp", "0", "--train_px", "256", "--epochs", "2",
                          "--batch_size", "2", "--train_dir", str(MESH_WORK / "train"),
                          "--ckpt_dir", str(ckpt), *flags])
    finally:
        config.qp_strategy, parallel.shutdown = keep
    return {"train_s": round(time.perf_counter() - t0, 3), "result": out,
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "deploy": str(ckpt / "deploy_params.npz"),
            "ok": out["global_step"] == 2 and (ckpt / "deploy_params.npz").exists()}


def _mesh_launches():
    """The launch counts since the last reset, by wrapper, bf16 entry, head
    dim and head count; the counters reset."""
    from sic_tpu_torch import ops
    heads = {k: {str(h): n for h, n in v.items()}
             for k, v in ops.heads_launch_counts().items()}
    return dict(_rank_launches(), heads_counts=heads)


def _rank_mesh(args):
    """One rank of the mesh phase: FSDP against DP, TP, the width split,
    the mesh runtime, then (rank 0, rank 1 idle) the one-process
    references and the judgement, then the train CLI with --tp 2 and with
    --fsdp.  The launches of each sharded run are read around it."""
    import os
    import torch
    from sic_tpu_torch.parallel import barrier, make_mesh, rank_device, setup_distributed
    rank, world = setup_distributed(device=rank_device(int(os.environ["RANK"])))
    device = rank_device(rank)
    grid = ("data", "model", "tile")
    x = _mp_batch()
    wide = _mesh_wide(x)
    rec = {"rank": rank, "launches": {}}
    partial = MESH_WORK / f"mesh_rank{rank}.partial.json"

    def keep():         # what the rank has so far, for a run that fails later
        partial.write_text(json.dumps(rec, default=float))

    t0 = time.perf_counter()
    rec["block_s"] = blocks = {}

    def lap(name):
        nonlocal t0
        blocks[name] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()

    _mesh_launches()
    rec["fsdp"] = _mesh_fsdp(device, grid, x)
    rec["launches"]["fsdp"] = _mesh_launches()
    lap("fsdp")
    keep()
    runs = {}
    for name, shape, xs in (("tp", (1, 2, 1), x), ("tile", (1, 1, 2), wide)):
        runs[name], peak = _mesh_steps(device, make_mesh(shape, grid), xs)
        rec["launches"][name] = _mesh_launches()
        rec[name] = {"peak_gb": peak, **{
            f"{s}_{k}": runs[name][s][k] for s in ("feat", "pix")
            for k in ("step_ms", "init_s", "bytes_at_rest")}}
        lap(name)
        keep()
    rec["runtime"] = _mesh_runtime(device, grid)
    rec["launches"]["runtime"] = rec["runtime"].pop("launches")
    lap("runtime")
    keep()
    barrier("mesh_runs_done")
    if rank == 0:
        refs = _mesh_references(device, x, wide)
        rec["reference_launches"] = _mesh_launches()    # not the path's
        rec["compare"] = _mesh_judge(runs, refs, device)
        rec["reference_step_ms"] = {k: {s: v[s]["step_ms"] for s in v} for k, v in refs.items()}
        del refs
        keep()
    del runs
    torch.cuda.empty_cache()
    barrier("mesh_references_done")
    lap("references")
    with _reduced_depth(CLI_TRUNK_LAYERS):
        rec["cli_tp"] = _mesh_cli(["--tp", "2"], "tp_ck")
        rec["cli_fsdp"] = _mesh_cli(["--fsdp"], "fsdp_ck", last=True)
        rec["launches"]["cli"] = _mesh_launches()
        lap("clis")
        # each rank one run's deployment parameters through the deploy CLIs
        deploy = Path(rec["cli_tp" if rank == 0 else "cli_fsdp"]["deploy"])
        rec["round_trip"] = _deploy_round_trip(deploy, HELDOUT / "val0.png")
    rec["cli_trunk_layers"] = CLI_TRUNK_LAYERS
    lap("round_trip")
    return rec


@contextlib.contextmanager
def _reduced_depth(layers):
    """The flagship spec with TiTok-L's trunks cut to ``layers`` of their
    24 layers at their full width (1024 wide, 16 heads; the insert
    positions past the cut drop out, as for any depth): the train CLIs and
    their deploy round trips, whose time goes to building, checkpointing
    and reading back the whole model."""
    from sic_tpu_torch import config
    keep = config._VIT_SIZES["large"]
    config._VIT_SIZES["large"] = (keep[0], layers, keep[2])
    try:
        yield
    finally:
        config._VIT_SIZES["large"] = keep


def rank_main(argv) -> int:
    """``chip_smoke.py --rank-task <compress|train|mesh> <record.json> [args]``:
    one rank of the multiprocess phase (WORLD_SIZE, RANK, MASTER_ADDR and
    MASTER_PORT in the environment); writes its record and the launch
    counts of its multi-process runs (not of rank 0's one-process
    references)."""
    from sic_tpu_torch import ops
    from sic_tpu_torch.models import configure_numerics
    configure_numerics()
    task, out, args = argv[0], Path(argv[1]), argv[2:]
    ops.reset_launch_counts()
    rec = {"compress": _rank_compress, "train": _rank_train,
           "mesh": _rank_mesh}[task](args)
    out.write_text(json.dumps(rec, default=float))
    return 0


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
    if sys.argv[1:2] == ["--rank-task"]:
        return rank_main(sys.argv[2:])
    from sic_tpu_torch.models import configure_numerics
    configure_numerics()
    WORK.mkdir(parents=True, exist_ok=True)

    smoke = Smoke(torch)
    # ``--phases a,b``: those phases alone (a check while working on one;
    # no kernels or result line)
    only = sys.argv[sys.argv.index("--phases") + 1].split(",") \
        if "--phases" in sys.argv else None

    def run(name, fn):
        if only is None or name in only:
            smoke.phase(name, fn)

    smoke.phase("build", smoke.build)
    if smoke.failed:
        return 1
    run("kernels", smoke.kernel_checks)
    run("golden", smoke.golden)
    run("encode", smoke.encode)
    if "encode" not in smoke.failed:
        run("flagship", smoke.flagship)
        run("op", smoke.op)
        run("serve", smoke.serve)
        run("surface", smoke.surface)
        run("bf16", smoke.bf16)
        run("int8", smoke.int8)
        run("train", smoke.train)
        run("train_bf16", smoke.train_bf16)
    run("generate", smoke.generate)
    if not {"encode", "flagship"} & set(smoke.failed):
        run("cpu", smoke.cpu_compare)
    if "encode" not in smoke.failed:
        run("multiprocess", smoke.multiprocess)
    run("mesh", smoke.mesh)
    if getattr(smoke, "rt", None) is not None:
        smoke.rt.close()
    shutil.rmtree(TRAIN_WORK, ignore_errors=True)
    if only is not None:
        print(f"phases run: {['build'] + only}; failed: {smoke.failed}", file=sys.stderr)
        return 1 if smoke.failed else 0
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
