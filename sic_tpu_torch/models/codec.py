"""Top-level codec and its deployment runtime.

Counterpart of the JAX package's ``models/codec.py`` (reference:
src/models/codec_sq_fixbpp.py:442-922).  :class:`Codec` holds the encode
and decode modules, the VQGAN teacher encoder that only training runs, and
the training forward; :class:`CodecRuntime` turns images into real bitstreams and back:
the semantic (TiTok token) stream through a uniform-CDF rANS coder (or, with
``z_format="torchac"``, the reference's arithmetic coder), the detail (h)
stream through the bottleneck's autoregressive chain on the host
coder or on the device rANS kernels, then the generative decode to pixels.
"""
from __future__ import annotations

import copy
import itertools
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import CodecSpec
from ..entropy import EntropyCoder
from ..entropy.torchac_compat import UniformTorchacCodec
from ..ops.quant import quantize_linears, resolve_quant
from ..parallel.collectives import (all_gather_cat, chunk_of, no_tile,
                                    tile_gather, tile_group, tile_parallel,
                                    tile_scatter)
from ..utils.profiling import timed_stage
from .bottleneck import BottleneckCoder
from .hybrid import FeatMerge, HybridCodec
from .layers import cast_compute, set_compute_dtype
from .vqgan import VQGAN


Z_CODERS = ("rans", "torchac")   # wire formats of the semantic stream


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  With no card and no explicit choice this raises; it never
    carries on quietly on the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def configure_numerics() -> None:
    """Full-fp32 matmuls and convolutions with deterministic algorithms,
    and bf16 matmuls that reduce in f32.

    The decoder recomputes the encoder's CDF-index planes bit for bit, so
    the prior CNN must give the same floats on both sides of a stream:
    TF32 (cuDNN's default for fp32 convs) and run-to-run algorithm search
    would break that.  A bf16 GEMM (the bf16 serving mode) accumulates in
    f32, as the TPU's matrix unit does, not in cuBLAS's reduced-precision
    split reductions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(dtype, device) -> torch.dtype:
    """The compute dtype of a runtime on ``device``: ``None`` or ``"auto"``
    follows the JAX package's rule (bf16 on an accelerator, here CUDA;
    fp32 on the CPU); ``"float32"`` / ``"bfloat16"``, or the torch dtype
    itself, names one of the two."""
    if dtype is None or dtype == "auto":
        return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    if isinstance(dtype, str):
        if dtype not in DTYPES:
            raise ValueError(f"dtype {dtype!r}: one of auto, {', '.join(DTYPES)}")
        return DTYPES[dtype]
    if dtype not in DTYPES.values():
        raise ValueError(f"dtype {dtype}: float32 or bfloat16")
    return dtype


def get_padding_size(height: int, width: int, p: int = 256):
    """Pad to a multiple of ``p``, right and bottom only, as ``(l, r, t, b)``
    (reference: compression_model.py:13-22)."""
    new_h = (height + p - 1) // p * p
    new_w = (width + p - 1) // p * p
    return 0, new_w - width, 0, new_h - height


def pad_replicate(x: torch.Tensor, pads) -> torch.Tensor:
    """NHWC replicate padding by ``(l, r, t, b)`` (the reference's F.pad
    'replicate')."""
    if not any(pads):
        return x
    return F.pad(x.permute(0, 3, 1, 2), tuple(pads),
                 mode="replicate").permute(0, 2, 3, 1)


class Codec(nn.Module):
    """Hybrid codec + VQGAN (pixel decoder and teacher encoder) + prior
    fusion (parameter names mirror the JAX package's tree).

    ``dtype``: the compute dtype, as the JAX package's ``Codec(spec,
    dtype)``: with ``torch.bfloat16`` every Linear and Conv outside the
    detail bottleneck computes in bf16 on its stored (f32) parameters
    (:meth:`set_compute_dtype`); the bottleneck, the norms, the positional
    parameters and the codebooks compute in f32, and so does the coding
    chain (the JAX bottleneck takes no dtype).  ``spec.remat`` (a YAML's
    ``save_mem``) recomputes the trunk blocks, the cross blocks and the
    detail refiners in the backward, as the JAX package's ``nn.remat``.

    ``pp``: a :class:`~.hybrid.PPConfig` runs both hybrid trunks as GPipe
    stages over its process group (the JAX package's ``Codec(spec, dtype,
    pp)``); the model is built whole, so that a seeded initialisation or a
    named checkpoint loads as it would without ``pp``, and
    :meth:`prune_to_stage` then keeps this stage's trunk cells only."""

    def __init__(self, spec: CodecSpec, dtype: Optional[torch.dtype] = None,
                 pp=None):
        super().__init__()
        s = spec
        self.spec = spec
        self.hybrid_codec = HybridCodec(s.titok, s.insert_pos_enc,
                                        s.insert_pos_dec, s.feat_width,
                                        s.quant_dim, s.num_attns, s.remat, pp)
        self.vqgan = VQGAN(s.vqgan)
        self.prior_fusion = FeatMerge(s.titok.width, s.feat_width,
                                      s.vqgan.n_embed, s.merge_inner_width)
        if dtype is not None:
            self.set_compute_dtype(dtype)

    def prune_to_stage(self) -> "Codec":
        """Drop the other pipeline stages' trunk cells (no-op without
        ``pp``)."""
        self.hybrid_codec.prune_to_stage()
        return self

    def set_compute_dtype(self, dtype: torch.dtype,
                          cast_weights: bool = False) -> "Codec":
        """Make every Linear and Conv outside the bottleneck compute in
        ``dtype``; ``cast_weights`` also casts their weights to it once
        (the serving runtime's bf16 copy)."""
        hc = self.hybrid_codec
        for m in (hc.encoder, hc.decoder, self.vqgan, self.prior_fusion):
            (cast_compute if cast_weights else set_compute_dtype)(m, dtype)
        return self

    def encode_stage(self, x01):
        """[0, 1] padded image -> (z token indices (BT, n_latent), detail
        latent (B, H/32, W/32, feat_width), stack_shape).  Under the width
        split ``x01`` is this rank's slab and the results are the whole
        image's (gathered), the same on every rank."""
        hc = self.hybrid_codec
        group = tile_group()
        if group is not None and x01.shape[2] % self.spec.tile_px:
            with no_tile():     # a tile straddles ranks: the whole width
                return self.encode_stage(tile_gather(x01, group))
        z, h, stack_shape = hc.encoder(x01, hc.latent_tokens)
        idx = hc.quantize.encode_indices(z)
        if group is None:
            return idx, h, stack_shape
        nH, nW = stack_shape
        idx = tile_gather(idx.reshape(-1, nH, nW, idx.shape[-1]), group)
        return (idx.reshape(-1, idx.shape[-1]), tile_gather(h, group),
                (nH, nW * group.size))

    def encode_to_vqgan(self, x):
        """x in [-1, 1] -> (teacher latent, teacher indices) from the frozen
        VQGAN encoder (reference: codec_sq_fixbpp.py:650-655)."""
        h_q, _, info = self.vqgan.quantize(self.vqgan.encode_latent(x))
        return h_q, info["indices"]

    def decode_to_latent(self, titok_hat, feat_hat):
        """Soft codebook mixture from fused logits
        (reference: codec_sq_fixbpp.py:658-663)."""
        logits = self.prior_fusion(titok_hat, feat_hat)
        # f32 softmax and mixture in every compute dtype, cast back
        probs = torch.softmax(logits.float(), dim=-1)
        latent = torch.matmul(probs, self.vqgan.quantize.codebook())
        return latent.to(logits.dtype), logits

    def decode_to_image(self, quantized_latent, return_pre: bool = False):
        return self.vqgan.decode(quantized_latent, return_pre=return_pre)

    def forward(self, x, need_full_decode: bool = True, training: bool = False,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                return_pre_out: bool = False) -> Dict:
        """The training forward: x (B, H, W, 3) in [-1, 1] (the hybrid
        branch sees [0, 1]; reference: codec_sq_fixbpp.py:673).  ``noise``
        or ``generator`` feed the bottleneck's rate noise."""
        enc = self.hybrid_codec(x * 0.5 + 0.5, training, noise, generator)
        latent, logits = self.decode_to_latent(enc["titok_hat"], enc["feat_hat"])
        x_hat = pre_out = None
        if need_full_decode:
            if return_pre_out:
                x_hat, pre_out = self.decode_to_image(latent, return_pre=True)
            else:
                x_hat = self.decode_to_image(latent)
        return {"x": x, "x_hat": x_hat, "pre_out": pre_out,
                "bpp_loss": enc["h_result_dict"]["bpp"],
                "bpp_hard_quant": enc["h_result_dict"]["bpp_direct"],
                "vq_loss": enc["z_result_dict"]["quantizer_loss"],
                "logits": logits, "vqgan_latent": latent}

    def decode_stage(self, z_indices, h_hat, stack_shape):
        """Token indices + decoded detail latent -> [-1, 1] image.  Under
        the width split the inputs are the whole image's and the result is
        this rank's slab: the hybrid decoder runs on the rank's own tiles
        (on every tile, the same on each rank, when they do not split
        evenly)."""
        hc = self.hybrid_codec
        z_hat = hc.decode_z_indices(z_indices)
        stack_shape = tuple(stack_shape)
        group = tile_group()
        if group is None:
            titok_hat, feat_hat = hc.decoder(z_hat, h_hat, stack_shape)
        elif stack_shape[1] % group.size == 0:
            nH, nW = stack_shape
            z_hat = chunk_of(z_hat.reshape(-1, nH, nW, *z_hat.shape[1:]), group, 2)
            titok_hat, feat_hat = hc.decoder(
                z_hat.reshape(-1, *z_hat.shape[3:]), chunk_of(h_hat, group, 2),
                (nH, nW // group.size))
        else:
            with no_tile():
                titok_hat, feat_hat = hc.decoder(z_hat, h_hat, stack_shape)
            titok_hat, feat_hat = (tile_scatter(t, group) for t in (titok_hat, feat_hat))
        latent, _ = self.decode_to_latent(titok_hat, feat_hat)
        return torch.clamp(self.decode_to_image(latent), -1.0, 1.0)


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] floats -> uint8 pixels, truncating as the JAX package does
    (in x's dtype: bf16 pixels round in bf16, as its bf16 mode's do)."""
    return torch.clamp((x + 1.0) * 127.5, 0.0, 255.0).to(torch.uint8)


def _nhwc_feat_shape(feat_shape, feat_width: int):
    """feat_shape as stored: (B, H, W, C), or torch NCHW from reference
    files (codec_sq_fixbpp.py:867)."""
    fs = tuple(int(s) for s in feat_shape)
    if fs[1] == feat_width and fs[-1] != feat_width:
        fs = (fs[0], fs[2], fs[3], fs[1])
    return fs


class EncodeRouter:
    """Encode-path policy: host coder (fetch the packed planes, native
    rANS) or device coder (rANS kernel, fetch only the finished stream).

    Pure host-side state machine, ported as is from the JAX package, so
    both packages route the same feed the same way:

    1. Route on the realized host cost: ``host_spb`` is an EMA of seconds
       per byte over actual packed-plane fetches.
    2. Asymmetric adaptation: a worse-than-EMA observation weighs 0.7, a
       better one 0.3.
    3. Minority-path exploration: the kernel-cost EMA updates only on the
       device path and the link cost only on the host path, so every
       ``explore_every``-th decision takes the minority path.

    The default priors (seconds of kernel walk per coding chunk, the
    packed/stream byte ratio) are the JAX package's values, kept so that
    routing agrees; they describe no measurement of this port.  Concurrent
    encodes (``encode_decode_many``, the service) feed and ask it from
    several threads: one lock orders its updates."""

    def __init__(self, dev_chunk_s: float = 0.09, dev_shrink: float = 8.0,
                 explore_every: int = 16):
        self.host_spb: Optional[float] = None   # realized host s/byte EMA
        self.link_bw: Optional[float] = None    # bytes/s EMA (observability)
        self.dev_chunk_s = dev_chunk_s          # kernel s/chunk EMA
        self.dev_shrink = dev_shrink            # packed/stream byte ratio EMA
        self.explore_every = explore_every
        self._n = 0                             # auto decisions taken
        self.last_explored = False              # observability
        self._lock = threading.Lock()

    def note_fetch(self, nbytes: int, secs: float) -> None:
        """Feed a realized device->host fetch (large transfers only: small
        ones measure latency, not the transfer cost)."""
        if nbytes < (1 << 18) or secs <= 0:
            return
        bw = nbytes / secs
        spb = secs / nbytes
        with self._lock:
            self.link_bw = (bw if self.link_bw is None
                            else 0.5 * self.link_bw + 0.5 * bw)
            if self.host_spb is None:
                self.host_spb = spb
            elif spb > self.host_spb:
                self.host_spb = 0.3 * self.host_spb + 0.7 * spb
            else:
                self.host_spb = 0.7 * self.host_spb + 0.3 * spb

    def note_device_encode(self, dev_s: float, stream_bytes: int,
                           packed_bytes: int, n_chunks: int) -> None:
        """Feed a realized device-path encode (kernel walk + stream fetch)."""
        with self._lock:
            if self.host_spb is not None:
                kern = max(dev_s - stream_bytes * self.host_spb, 1e-3)
                self.dev_chunk_s = (0.5 * self.dev_chunk_s
                                    + 0.5 * kern / max(n_chunks, 1))
            if packed_bytes and stream_bytes:
                self.dev_shrink = (0.5 * self.dev_shrink
                                   + 0.5 * packed_bytes / stream_bytes)

    def decide(self, packed_bytes: int, n_chunks: int) -> bool:
        """True -> device path.  Call only for auto-routable batches."""
        with self._lock:
            if self.host_spb is None:
                self.last_explored = False
                return False             # the first batch measures the link
            t_host = packed_bytes * self.host_spb
            t_dev = (n_chunks * self.dev_chunk_s
                     + packed_bytes / self.dev_shrink * self.host_spb)
            choice = t_dev < t_host
            self._n += 1
            self.last_explored = bool(
                self.explore_every and self._n % self.explore_every == 0)
            return not choice if self.last_explored else choice


class CodecRuntime:
    """Host side of the real-bitstream encode and decode (reference:
    codec_sq_fixbpp.py:849-922).

    ``device_entropy``: ``"auto"`` decodes the h stream with the device
    rANS kernel on CUDA when the stream has >= 4 substreams, and lets
    :class:`EncodeRouter` pick the encode path on CUDA; ``"device"`` forces
    the kernel paths (on the CPU: their plain versions), ``"host"`` the
    host coder.

    The batched entry points take ``per_stream_networks``: True runs the
    network passes (the encoder, the pixel decoder) one stream at a time,
    at the shapes a single request runs them, and batches only the entropy
    chain, so a stream's bytes and pixels do not depend on the streams
    batched with it (the float libraries sum differently at another batch
    size); the service's batchers ask for it.  False (the CLIs) batches
    the networks too, for throughput.

    ``z_format``: the semantic stream's wire format this runtime writes,
    ``"rans"`` (its own) or ``"torchac"`` (the reference's); a decode
    reads either, by the stream's ``z_coder``.

    ``dtype``: the compute dtype of the network stages, as the JAX
    package's ``CodecRuntime(dtype=...)``: ``None`` (fp32) runs ``model``
    itself; ``torch.bfloat16`` runs ``encode_stage`` and ``decode_stage``
    on a runtime-owned copy of ``model`` (``self.net``) whose Linear and
    Conv weights are cast to bf16 once (:meth:`Codec.set_compute_dtype`),
    taken when the runtime is built.  The caller's model is left as it is,
    and the coding chain stays f32 in both modes: the detail latent ``h``
    enters the bottleneck coder in f32, and the coder and its prior are the
    caller's f32 modules, shared with any fp32 runtime of the same model.
    So a stream decodes in either mode.  ``decode_only`` returns f32 pixels
    (bf16 values, exactly) or uint8 pixels rounded as the JAX bf16 mode
    rounds them.

    ``quant``: ``"int8"`` serves the networks W8A8 (the JAX package's
    ``CodecRuntime(quant="int8")``): ``self.net`` is then a runtime-owned
    copy whose Linear layers, but for the two ``sensitive`` ones (the
    encoder's pre-VQ ``conv_out``, FeatMerge's ``ffn_fc2``), are
    :class:`~sic_tpu_torch.ops.quant.QuantLinear` quantized from the
    caller's f32 weights (then the rest is cast to a bf16 ``dtype``, and
    the QuantLinears return it); ``None`` or ``"none"`` serves float.  The
    coding chain is conv-only and stays the caller's f32 bottleneck, so
    streams decode to the same ``y_hat`` in every mode.

    Several threads may share one runtime (``decode_only_many``,
    ``round_trip_pipelined``, ``encode_decode_many``, the service): the
    coders are pooled, and the router and the path counts take a lock.

    ``mesh``: a process grid over ``data`` and ``tile``
    (:func:`~sic_tpu_torch.parallel.mesh.make_mesh`), the JAX package's
    ``CodecRuntime(mesh=)``: every rank builds the runtime and calls it
    with the whole batch; the parameters are replicated (broadcast from
    rank 0); the network passes split the batch's rows over ``data`` (a
    multiple of its size) and the width over ``tile``, and their results
    are gathered, so every rank gets the same result back.  The coding
    chain (the prior, the CDF indexes at the header's ``coding_batch``,
    fp32) runs unsplit on the gathered latent, so a stream encoded under a
    mesh decodes in a one-process runtime; the encode takes the host coder,
    as the JAX runtime's does under a mesh."""

    def __init__(self, spec: CodecSpec, model: Codec, stream_part: int = 1,
                 device_entropy: str = "auto", z_format: str = "rans",
                 dtype: Optional[torch.dtype] = None, quant: Optional[str] = None,
                 mesh=None):
        if device_entropy not in ("auto", "host", "device"):
            raise ValueError(f"device_entropy: {device_entropy}")
        if z_format not in Z_CODERS:
            raise ValueError(f"z_format: {z_format}")
        configure_numerics()
        self.spec = spec
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.dtype = torch.float32 if dtype is None else resolve_dtype(dtype, self.device)
        self.quant = resolve_quant(quant)
        if self.dtype == torch.float32 and self.quant is None:
            self.net = self.model
        else:
            # the bottleneck is shared, not copied: it stays the caller's f32
            bottleneck = model.hybrid_codec.quantize_feat
            self.net = copy.deepcopy(model, {id(bottleneck): bottleneck})
            if self.quant == "int8":
                quantize_linears(self.net)     # from the f32 weights
            if self.dtype != torch.float32:
                self.net.set_compute_dtype(self.dtype, cast_weights=True)
            self.net.eval()
        self.mesh = mesh
        if mesh is not None:
            if mesh.model is not None or mesh.size("pipe") > 1:
                raise ValueError("a runtime's mesh splits data and tile only")
            from ..parallel.mesh import shard_state
            shard_state([self.net] if self.net is self.model
                        else [self.model, self.net])
        self.stream_part = stream_part
        self.device_entropy = device_entropy
        self.h_coder = BottleneckCoder(model.hybrid_codec.quantize_feat,
                                       force_zero_thres=spec.force_zero_thres,
                                       stream_part=stream_part)
        # semantic-stream coders: uniform CDF over the TiTok codebook,
        # pooled so concurrent requests never share one stateful coder
        K = spec.titok.codebook_size
        precision = 16
        self._z_cdf = np.zeros((1, K + 1), np.int32)
        self._z_cdf[0, 1:] = np.cumsum(np.full(K, (1 << precision) // K, np.int64))
        self._z_cdf[0, -1] = 1 << precision
        self._z_pool: "queue.SimpleQueue" = queue.SimpleQueue()
        self._z_pool.put(self._new_z_coder())
        self.z_format = z_format
        self.z_torchac = UniformTorchacCodec(K)     # stateless: not pooled
        # host-side z coding overlaps the h chain
        self._io = ThreadPoolExecutor(max_workers=4, thread_name_prefix="sic-z")
        self.router = EncodeRouter()
        self.encode_path_counts = {"device": 0, "host": 0}
        self._count_lock = threading.Lock()
        # numbers each entry point's call in its spans (a trace's only)
        self._calls = itertools.count()

    def close(self) -> None:
        self._io.shutdown(wait=True)

    # -- semantic stream ------------------------------------------------------
    def _new_z_coder(self):
        K = self.spec.titok.codebook_size
        coder = EntropyCoder(self.stream_part)
        group = coder.add_cdf(self._z_cdf, np.array([K + 1], np.int32),
                              np.array([0], np.int32))
        return coder, group

    def _checkout_z(self):
        try:
            return self._z_pool.get_nowait()
        except queue.Empty:
            return self._new_z_coder()

    def encode_z(self, idx_np: np.ndarray) -> bytes:
        """Semantic-token indices -> stream (uniform CDF) in
        ``self.z_format``."""
        if self.z_format == "torchac":
            return self.z_torchac.encode(idx_np)
        coder, group = self._checkout_z()
        try:
            coder.reset()
            coder.encode_with_indexes(idx_np.reshape(-1).astype(np.int32),
                                      np.zeros(idx_np.size, np.int16), group)
            coder.flush()
            return coder.get_encoded_stream()
        finally:
            self._z_pool.put((coder, group))

    def _decode_z(self, z_bit_stream: bytes, token_length: int,
                  z_coder: str) -> np.ndarray:
        if z_coder == "torchac":
            return self.z_torchac.decode(z_bit_stream, int(token_length))
        if z_coder != "rans":
            raise ValueError(f"unknown semantic-stream coder {z_coder!r} "
                             f"(one of {Z_CODERS})")
        coder, group = self._checkout_z()
        try:
            coder.set_stream(z_bit_stream)
            return coder.decode_stream(np.zeros(int(token_length), np.int16),
                                       group)
        finally:
            self._z_pool.put((coder, group))

    # -- routing ----------------------------------------------------------------
    def _use_device_entropy(self, h_bit_stream: bytes, latent_shape) -> bool:
        """Device rANS for streams of >= 4 substreams on CUDA; ``"device"``
        forces it (then a CPU runtime runs the kernel's plain version)."""
        if self.device_entropy == "host":
            return False
        if not self.h_coder.can_decompress_on_device(h_bit_stream, latent_shape):
            return False
        if self.device_entropy == "device":
            return True
        nparts = (h_bit_stream[0] >> 4) + 1
        return self.device.type == "cuda" and nparts >= 4

    def _use_device_encode(self, packed_bytes: int, n_chunks: int,
                           latent_shape) -> bool:
        """Route an encode batch: the device coder when the predicted
        kernel walk beats the packed-plane fetch at the realized host cost
        (on CUDA), or when forced.  A plane that does not split into the
        substreams goes to the host coder before anything launches; under
        a mesh, every batch does."""
        if self.device_entropy == "host" or self.mesh is not None:
            return False
        if not self.h_coder.can_compress_on_device(latent_shape):
            return False
        if self.device_entropy == "device":
            return True
        if self.device.type != "cuda":
            return False
        return self.router.decide(packed_bytes, n_chunks)

    def _count_path(self, use_dev: bool) -> None:
        with self._count_lock:
            self.encode_path_counts["device" if use_dev else "host"] += 1

    @staticmethod
    def _check_coding_batch(cb):
        if cb is None:
            return None
        cb = int(cb)
        if not 1 <= cb <= 512:
            raise ValueError(f"bad coding_batch: {cb}")
        return cb

    def _rows(self, B: int) -> int:
        """This rank's rows of a B-image batch under the mesh."""
        n = self.mesh.size("data")
        if B % n:
            raise ValueError(f"a batch of {B} images does not split over "
                             f"{n} data ranks")
        return B // n

    @torch.no_grad()
    def _decode_pixels(self, z_indices, h_hat, stack_shape, output: str):
        if self.mesh is None:
            x = self.net.decode_stage(z_indices, h_hat, stack_shape)
        elif h_hat.shape[0] % self.mesh.size("data"):
            # rows that do not split over the data ranks run whole on each
            # (as decode_stage runs a tile that straddles ranks); the JAX
            # runtime shards only its encodes and decodes any batch
            with tile_parallel(self.mesh.tile):
                x = tile_gather(self.net.decode_stage(z_indices, h_hat, stack_shape))
        else:
            mesh, B = self.mesh, h_hat.shape[0]
            per = self._rows(B)
            i = mesh.data.index if mesh.data is not None else 0
            nt = z_indices.shape[0] // B
            with tile_parallel(mesh.tile):
                x = self.net.decode_stage(z_indices[i * per * nt:(i + 1) * per * nt],
                                          h_hat[i * per:(i + 1) * per], stack_shape)
                x = tile_gather(x)
            x = all_gather_cat(x, mesh.data, 0)
        return to_u8(x) if output == "u8" else x.float()

    def _encode_stage(self, x: torch.Tensor):
        """(z indices, h) of images in [-1, 1]; h in f32 for the coder.
        Under the mesh: this rank's rows and slab through the networks,
        the results gathered."""
        if self.mesh is None:
            z_indices, h, _ = self.net.encode_stage(x * 0.5 + 0.5)
            return z_indices, h.float()
        from ..parallel.mesh import shard_batch
        mesh = self.mesh
        self._rows(x.shape[0])
        xl = shard_batch(x, mesh)
        with tile_parallel(mesh.tile):
            z, h, _ = self.net.encode_stage(xl * 0.5 + 0.5)
        n = z.shape[-1]
        z = all_gather_cat(z.reshape(xl.shape[0], -1, n), mesh.data, 0)
        return z.reshape(-1, n), all_gather_cat(h, mesh.data, 0).float()

    # -- decode entry points ----------------------------------------------------
    def decode_only(self, z_bit_stream, h_bit_stream, img_shape, feat_shape,
                    stack_shape, token_length, z_indices_shape, timer=None,
                    z_coder: str = "rans", coding_batch=None,
                    output: str = "float", probe: Optional[Dict] = None,
                    **_ignored) -> torch.Tensor:
        """One stream -> x_hat (B, H, W, 3) in [-1, 1], or uint8 pixels with
        ``output="u8"``.  ``coding_batch``: the h stream's coding contract
        from the file header.  ``timer`` (a :class:`StageTimer`) records
        the JAX runtime's stages: ``z_rans`` (on a worker thread),
        ``h_rans``, ``decode_device``.  ``probe`` (optional dict) receives
        ``h_hat`` and the per-step planes (see :class:`BottleneckCoder`)."""
        coding_batch = self._check_coding_batch(coding_batch)
        zshape = tuple(int(s) for s in z_indices_shape)
        if len(zshape) == 4:   # reference files: (BT, token_size, 1, n_latent)
            zshape = (zshape[0], zshape[3])
        # fields from untrusted containers: bound and cross-check them
        token_length = int(token_length)
        if not (0 < token_length <= (1 << 24)) or \
                token_length != zshape[0] * zshape[1]:
            raise ValueError(
                f"inconsistent semantic-stream geometry: token_length="
                f"{token_length}, z_indices_shape={tuple(z_indices_shape)}")
        call = next(self._calls)

        def _z():
            with timed_stage(timer, "z_rans", call):
                return self._decode_z(z_bit_stream, token_length, z_coder)

        z_future = self._io.submit(_z)
        B, Hf, Wf, _ = _nhwc_feat_shape(feat_shape, self.spec.feat_width)
        latent_shape = (B, Hf, Wf, self.spec.quant_dim)
        with timed_stage(timer, "h_rans", call):
            if self._use_device_entropy(h_bit_stream, latent_shape):
                h_hat = self.h_coder.decompress_device(
                    h_bit_stream, latent_shape, coding_batch=coding_batch,
                    probe=probe)
            else:
                h_hat = self.h_coder.decompress(
                    h_bit_stream, latent_shape, coding_batch=coding_batch,
                    probe=probe)
        if probe is not None:
            probe["h_hat"] = h_hat
        z = torch.from_numpy(z_future.result().astype(np.int64).reshape(zshape))
        with timed_stage(timer, "decode_device", call):
            return self._decode_pixels(z.to(self.device), h_hat, stack_shape,
                                       output)

    def decode_only_many(self, enc_results, workers: int = 4) -> list:
        """Concurrent decodes, one :meth:`decode_only` a worker thread: each
        request checks out its own host coders, so one stream's host work
        overlaps another's kernels.  Each worker waits for its result on
        the card before it takes the next request, which bounds the work in
        flight to ``workers`` decodes.  Returns the x_hat list in order."""
        def _one(e):
            x = self.decode_only(**e)
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            return x

        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(_one, enc_results))

    def decode_only_batched(self, enc_results, timer=None, output: str = "float",
                            probe: Optional[Dict] = None,
                            per_stream_networks: bool = False) -> torch.Tensor:
        """Same-shaped streams decoded together: the 4 autoregressive steps
        run device-batched over all B streams with one host coder each, the
        pixel decoder batched or, with ``per_stream_networks``, one stream
        at a time.  ``timer`` as for :meth:`decode_only` (the JAX
        runtime's second positional argument).  Returns x_hat (B, H, W,
        3)."""
        if not enc_results:
            raise ValueError("empty batch")
        first = enc_results[0]
        for e in enc_results:
            if tuple(e["stack_shape"]) != tuple(first["stack_shape"]):
                raise ValueError("decode_only_batched needs same-shaped streams")
            # mixing contracts would replay the wrong float trajectory
            if e.get("coding_batch") != first.get("coding_batch"):
                raise ValueError("decode_only_batched needs one coding_batch")
        n_latent = int(first["z_indices_shape"][-1])
        call = next(self._calls)

        def _z_all():
            with timed_stage(timer, "z_rans", call):
                outs = [self._decode_z(e["z_bit_stream"], e["token_length"],
                                       e.get("z_coder", "rans"))
                        for e in enc_results]
                return np.concatenate(outs).astype(np.int64).reshape(-1, n_latent)

        z_future = self._io.submit(_z_all)
        fs = _nhwc_feat_shape(first["feat_shape"], self.spec.feat_width)
        latent_shape = (1, fs[1], fs[2], self.spec.quant_dim)
        # workers=1: the native coder already threads each stream over its
        # substreams, and a fan-out over the images on top was slower on an
        # H100 host (PERF.md)
        with timed_stage(timer, "h_rans", call):
            h_hat = self.h_coder.decompress_batched(
                [e["h_bit_stream"] for e in enc_results], latent_shape,
                workers=1,
                coding_batch=self._check_coding_batch(first.get("coding_batch")),
                probe=probe)
        if probe is not None:
            probe["h_hat"] = h_hat
        z = torch.from_numpy(z_future.result()).to(self.device)
        with timed_stage(timer, "decode_device", call):
            if not per_stream_networks or self.mesh is not None:
                return self._decode_pixels(z, h_hat, first["stack_shape"], output)
            nt = z.shape[0] // len(enc_results)
            outs = []
            for b, e in enumerate(enc_results):
                # a repeated stream (a padded lane) reuses its pixels
                outs.append(outs[-1] if b and e is enc_results[b - 1] else
                            self._decode_pixels(z[b * nt:(b + 1) * nt],
                                                h_hat[b:b + 1],
                                                first["stack_shape"], output))
            return torch.cat(outs)

    # -- encode entry points ----------------------------------------------------
    def _fetch_packed(self, packed: torch.Tensor) -> np.ndarray:
        """Packed planes to the host, feeding the router the realized cost."""
        t0 = time.perf_counter()
        with timed_stage(None, "h_rans.fetch"):
            out = packed.cpu().numpy()
        self.router.note_fetch(out.nbytes, time.perf_counter() - t0)
        return out

    def _images(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def encode_only(self, x, timer=None, probe: Optional[Dict] = None) -> Dict:
        """x: (B, H, W, 3) in [-1, 1], H and W multiples of the tile.  One
        stream pair for the batch.  ``timer`` (a :class:`StageTimer`)
        records the JAX runtime's stages: ``encode_device``, ``fetch``,
        ``h_rans``, ``z_rans``.  ``probe`` (optional dict) receives
        ``y_hat``, the reconstruction a decode must reproduce bit for bit,
        and ``h_path``."""
        x = self._images(x)
        B, H, W, _ = x.shape
        q = self.spec.quant_dim
        latent_shape = (B, H // 32, W // 32, q)
        # only a single image may take the device coder here: it writes one
        # stream per image, this entry point one stream per batch
        use_dev = B == 1 and self._use_device_encode(
            4 * (H // 32) * (W // 32) * q, 1, latent_shape)
        self._count_path(use_dev)
        stack_shape = (H // self.spec.tile_px, W // self.spec.tile_px)
        call = next(self._calls)
        with timed_stage(timer, "encode_device", call):
            z_indices, h = self._encode_stage(x)
            if use_dev:
                streams, y_hat = self.h_coder.compress_device(h)
            else:
                packed, y_hat = self.h_coder.compress_plan(h)
        with timed_stage(timer, "fetch", call):
            if not use_dev:
                packed = self._fetch_packed(packed)
            z_np = z_indices.cpu().numpy()
        with timed_stage(timer, "h_rans", call):
            h_bit_stream = streams[0] if use_dev else \
                self.h_coder.encode_packed(packed)
        if probe is not None:
            probe["y_hat"] = y_hat
            probe["h_path"] = "device" if use_dev else "host"
        with timed_stage(timer, "z_rans", call):
            z_bit_stream = self.encode_z(z_np)
        return {
            "z_bit_stream": z_bit_stream,
            "h_bit_stream": h_bit_stream,
            "img_shape": (H, W),
            "feat_shape": tuple(h.shape),
            "stack_shape": stack_shape,
            "token_length": int(z_np.size),
            "z_indices_shape": tuple(z_np.shape),
        }

    def _encode_networks(self, x: torch.Tensor, per_stream: bool):
        """(z_indices, h) of a batch: one pass, or with ``per_stream`` one
        pass an image (a repeated image, a padded lane, reuses its
        result; not under a mesh, whose pass splits the batch)."""
        if not per_stream or self.mesh is not None:
            return self._encode_stage(x)
        outs = []
        for b in range(x.shape[0]):
            outs.append(outs[-1] if b and torch.equal(x[b], x[b - 1]) else
                        self._encode_stage(x[b:b + 1]))
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    @torch.no_grad()
    def encode_only_batched(self, x, timer=None, probe: Optional[Dict] = None,
                            per_stream_networks: bool = False) -> list:
        """Batched encode: one device pass for B images (with
        ``per_stream_networks`` one an image), then B independent per-image
        bitstreams (each decodable alone).  The throughput path for corpus
        indexing.

        On the host path the work streams per coding-batch chunk: every
        chunk's chain is enqueued first, then chunk j's packed planes come
        back as soon as its chain completes and go to the host rANS on a
        worker thread while chunks j+1.. still compute (the native coder
        releases the GIL).  ``timer`` and ``probe`` as for
        :meth:`encode_only`; the stages overlap here, as in the JAX runtime
        (``z_rans`` on a worker thread, ``fetch`` once a chunk), so their
        sum can exceed the wall time."""
        x = self._images(x)
        B, H, W, _ = x.shape
        if B == 1:
            # single requests take the latency path, field-compatible
            return [self.encode_only(x, timer=timer, probe=probe)]
        stack_shape = (H // self.spec.tile_px, W // self.spec.tile_px)
        n_tiles = stack_shape[0] * stack_shape[1]
        call = next(self._calls)
        with timed_stage(timer, "encode_device", call):
            z_indices, h = self._encode_networks(x, per_stream_networks)
        n_chunks = len(self.h_coder._chunk_batches(B))
        q = self.spec.quant_dim
        packed_bytes = 4 * B * int(h.shape[1]) * int(h.shape[2]) * q
        use_dev = self._use_device_encode(
            packed_bytes, n_chunks, (B, int(h.shape[1]), int(h.shape[2]), q))
        self._count_path(use_dev)

        def _z_all():
            with timed_stage(timer, "z_rans", call):
                z_np = z_indices.cpu().numpy()
                return [self.encode_z(z_np[b * n_tiles:(b + 1) * n_tiles])
                        for b in range(B)]

        if use_dev:
            t0 = time.perf_counter()
            with timed_stage(timer, "h_rans", call):
                h_streams, y_hat = self.h_coder.compress_device(h)
            self.router.note_device_encode(
                time.perf_counter() - t0, sum(len(s) for s in h_streams),
                packed_bytes, n_chunks)
            z_streams = _z_all()
        else:
            with timed_stage(timer, "encode_device", call):
                chunk_plans = self.h_coder.compress_plan_chunks(h)
            z_future = self._io.submit(_z_all)
            h_streams: list = [None] * B
            pending = []
            for start, real, packed_dev, _yh in chunk_plans:
                with timed_stage(timer, "fetch", call):
                    packed = self._fetch_packed(packed_dev)  # waits for this chunk
                # one worker, as in decode_only_batched
                pending.append((start, real, self._io.submit(
                    self.h_coder.encode_packed_many, packed, 1)))
            with timed_stage(timer, "h_rans", call), \
                    timed_stage(None, "h_rans.code", call):
                # the coder runs on the pool: this thread waits for it
                for start, real, fut in pending:
                    h_streams[start:start + real] = fut.result()
            z_streams = z_future.result()
            y_hat = torch.cat([c[3] for c in chunk_plans])
        if probe is not None:
            probe["y_hat"] = y_hat
            probe["h_path"] = "device" if use_dev else "host"
        feat_shape_1 = (1, int(h.shape[1]), int(h.shape[2]), int(h.shape[3]))
        n_latent = int(z_indices.shape[-1])
        return [{
            "z_bit_stream": z_streams[b],
            "h_bit_stream": h_streams[b],
            "img_shape": (H, W),
            "feat_shape": feat_shape_1,
            "stack_shape": stack_shape,
            "token_length": n_tiles * n_latent,
            "z_indices_shape": (n_tiles, n_latent),
        } for b in range(B)]

    def round_trip_pipelined(self, batches) -> list:
        """Two-stage pipeline over same-shaped image batches: batch k+1's
        encode (network pass and host rANS) runs on a worker thread while
        batch k decodes.  Returns the x_hat of each batch, equal to
        ``decode_only_batched(encode_only_batched(b))``."""
        outs = []
        with ThreadPoolExecutor(max_workers=2) as pool:
            enc_f = pool.submit(self.encode_only_batched, batches[0])
            for i in range(len(batches)):
                encs = enc_f.result()
                if i + 1 < len(batches):
                    enc_f = pool.submit(self.encode_only_batched, batches[i + 1])
                outs.append(self.decode_only_batched(encs))
        return outs

    def encode_decode_many(self, images, original_shapes=None,
                           workers: int = 2) -> list:
        """:meth:`encode_decode` over a list of (1, H, W, 3) images on
        ``workers`` threads, so one image's host coding overlaps the next
        one's kernels.  Returns a list of (x_hat, bpp_dict, enc_result)."""
        shapes = original_shapes or [tuple(im.shape[-3:-1]) for im in images]
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(self.encode_decode, images, shapes))

    def encode_decode(self, x, original_shape: Tuple[int, int]):
        """Round trip with bpp accounting (reference:
        codec_sq_fixbpp.py:904-922)."""
        enc_result = self.encode_only(x)
        x_hat = self.decode_only(**enc_result)
        z_bits = len(enc_result["z_bit_stream"]) * 8
        h_bits = len(enc_result["h_bit_stream"]) * 8
        overhead_bits = 8 * 6  # 4 B height/width + 2 B token-stream length
        h, w = original_shape
        bpp_dict = {
            "z_bpp": z_bits / (h * w),
            "h_bpp": h_bits / (h * w),
            "overhead_bpp": overhead_bits / (h * w),
            "total_bpp": (z_bits + h_bits + overhead_bits) / (h * w),
        }
        return x_hat, bpp_dict, enc_result
