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
from .bottleneck import BottleneckCoder
from .hybrid import FeatMerge, HybridCodec
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
    """Full-fp32 matmuls and convolutions with deterministic algorithms.

    The decoder recomputes the encoder's CDF-index planes bit for bit, so
    the prior CNN must give the same floats on both sides of a stream:
    TF32 (cuDNN's default for fp32 convs) and run-to-run algorithm search
    would break that."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


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
    fusion (parameter names mirror the JAX package's tree)."""

    def __init__(self, spec: CodecSpec):
        super().__init__()
        s = spec
        self.spec = spec
        self.hybrid_codec = HybridCodec(s.titok, s.insert_pos_enc,
                                        s.insert_pos_dec, s.feat_width,
                                        s.quant_dim, s.num_attns)
        self.vqgan = VQGAN(s.vqgan)
        self.prior_fusion = FeatMerge(s.titok.width, s.feat_width,
                                      s.vqgan.n_embed, s.merge_inner_width)

    def encode_stage(self, x01):
        """[0, 1] padded image -> (z token indices (BT, n_latent), detail
        latent (B, H/32, W/32, feat_width), stack_shape)."""
        hc = self.hybrid_codec
        z, h, stack_shape = hc.encoder(x01, hc.latent_tokens)
        return hc.quantize.encode_indices(z), h, stack_shape

    def encode_to_vqgan(self, x):
        """x in [-1, 1] -> (teacher latent, teacher indices) from the frozen
        VQGAN encoder (reference: codec_sq_fixbpp.py:650-655)."""
        h_q, _, info = self.vqgan.quantize(self.vqgan.encode_latent(x))
        return h_q, info["indices"]

    def decode_to_latent(self, titok_hat, feat_hat):
        """Soft codebook mixture from fused logits
        (reference: codec_sq_fixbpp.py:658-663)."""
        logits = self.prior_fusion(titok_hat, feat_hat)
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
        """Token indices + decoded detail latent -> [-1, 1] image."""
        z_hat = self.hybrid_codec.decode_z_indices(z_indices)
        titok_hat, feat_hat = self.hybrid_codec.decoder(z_hat, h_hat,
                                                        tuple(stack_shape))
        latent, _ = self.decode_to_latent(titok_hat, feat_hat)
        return torch.clamp(self.decode_to_image(latent), -1.0, 1.0)


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] floats -> uint8 pixels, truncating as the JAX package does."""
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

    Several threads may share one runtime (``decode_only_many``,
    ``round_trip_pipelined``, ``encode_decode_many``, the service): the
    coders are pooled, and the router and the path counts take a lock."""

    def __init__(self, spec: CodecSpec, model: Codec, stream_part: int = 1,
                 device_entropy: str = "auto", z_format: str = "rans"):
        if device_entropy not in ("auto", "host", "device"):
            raise ValueError(f"device_entropy: {device_entropy}")
        if z_format not in Z_CODERS:
            raise ValueError(f"z_format: {z_format}")
        configure_numerics()
        self.spec = spec
        self.model = model.eval()
        self.device = next(model.parameters()).device
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
        substreams goes to the host coder before anything launches."""
        if self.device_entropy == "host":
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

    @torch.no_grad()
    def _decode_pixels(self, z_indices, h_hat, stack_shape, output: str):
        x = self.model.decode_stage(z_indices, h_hat, stack_shape)
        return to_u8(x) if output == "u8" else x

    # -- decode entry points ----------------------------------------------------
    def decode_only(self, z_bit_stream, h_bit_stream, img_shape, feat_shape,
                    stack_shape, token_length, z_indices_shape,
                    z_coder: str = "rans", coding_batch=None,
                    output: str = "float", probe: Optional[Dict] = None,
                    **_ignored) -> torch.Tensor:
        """One stream -> x_hat (B, H, W, 3) in [-1, 1], or uint8 pixels with
        ``output="u8"``.  ``coding_batch``: the h stream's coding contract
        from the file header.  ``probe`` (optional dict) receives
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
        z_future = self._io.submit(self._decode_z, z_bit_stream, token_length,
                                   z_coder)
        B, Hf, Wf, _ = _nhwc_feat_shape(feat_shape, self.spec.feat_width)
        latent_shape = (B, Hf, Wf, self.spec.quant_dim)
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
        return self._decode_pixels(z.to(self.device), h_hat, stack_shape, output)

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

    def decode_only_batched(self, enc_results, output: str = "float",
                            probe: Optional[Dict] = None,
                            per_stream_networks: bool = False) -> torch.Tensor:
        """Same-shaped streams decoded together: the 4 autoregressive steps
        run device-batched over all B streams with one host coder each, the
        pixel decoder batched or, with ``per_stream_networks``, one stream
        at a time.  Returns x_hat (B, H, W, 3)."""
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

        def _z_all():
            outs = [self._decode_z(e["z_bit_stream"], e["token_length"],
                                   e.get("z_coder", "rans"))
                    for e in enc_results]
            return np.concatenate(outs).astype(np.int64).reshape(-1, n_latent)

        z_future = self._io.submit(_z_all)
        fs = _nhwc_feat_shape(first["feat_shape"], self.spec.feat_width)
        latent_shape = (1, fs[1], fs[2], self.spec.quant_dim)
        h_hat = self.h_coder.decompress_batched(
            [e["h_bit_stream"] for e in enc_results], latent_shape,
            coding_batch=self._check_coding_batch(first.get("coding_batch")),
            probe=probe)
        if probe is not None:
            probe["h_hat"] = h_hat
        z = torch.from_numpy(z_future.result()).to(self.device)
        if not per_stream_networks:
            return self._decode_pixels(z, h_hat, first["stack_shape"], output)
        nt = z.shape[0] // len(enc_results)
        outs = []
        for b, e in enumerate(enc_results):
            # a repeated stream (a padded lane) reuses its pixels
            outs.append(outs[-1] if b and e is enc_results[b - 1] else
                        self._decode_pixels(z[b * nt:(b + 1) * nt], h_hat[b:b + 1],
                                            first["stack_shape"], output))
        return torch.cat(outs)

    # -- encode entry points ----------------------------------------------------
    def _fetch_packed(self, packed: torch.Tensor) -> np.ndarray:
        """Packed planes to the host, feeding the router the realized cost."""
        t0 = time.perf_counter()
        out = packed.cpu().numpy()
        self.router.note_fetch(out.nbytes, time.perf_counter() - t0)
        return out

    def _images(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def encode_only(self, x, probe: Optional[Dict] = None) -> Dict:
        """x: (B, H, W, 3) in [-1, 1], H and W multiples of the tile.  One
        stream pair for the batch.  ``probe`` (optional dict) receives
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
        z_indices, h, _ = self.model.encode_stage(x * 0.5 + 0.5)
        stack_shape = (H // self.spec.tile_px, W // self.spec.tile_px)
        if use_dev:
            streams, y_hat = self.h_coder.compress_device(h)
            h_bit_stream = streams[0]
        else:
            packed, y_hat = self.h_coder.compress_plan(h)
            h_bit_stream = self.h_coder.encode_packed(self._fetch_packed(packed))
        if probe is not None:
            probe["y_hat"] = y_hat
            probe["h_path"] = "device" if use_dev else "host"
        z_np = z_indices.cpu().numpy()
        return {
            "z_bit_stream": self.encode_z(z_np),
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
        result)."""
        if not per_stream:
            return self.model.encode_stage(x * 0.5 + 0.5)[:2]
        outs = []
        for b in range(x.shape[0]):
            outs.append(outs[-1] if b and torch.equal(x[b], x[b - 1]) else
                        self.model.encode_stage(x[b:b + 1] * 0.5 + 0.5)[:2])
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    @torch.no_grad()
    def encode_only_batched(self, x, probe: Optional[Dict] = None,
                            per_stream_networks: bool = False) -> list:
        """Batched encode: one device pass for B images (with
        ``per_stream_networks`` one an image), then B independent per-image
        bitstreams (each decodable alone).  The throughput path for corpus
        indexing.

        On the host path the work streams per coding-batch chunk: every
        chunk's chain is enqueued first, then chunk j's packed planes come
        back as soon as its chain completes and go to the host rANS on a
        worker thread while chunks j+1.. still compute (the native coder
        releases the GIL).  ``probe`` as for :meth:`encode_only`."""
        x = self._images(x)
        B, H, W, _ = x.shape
        if B == 1:
            # single requests take the latency path, field-compatible
            return [self.encode_only(x, probe=probe)]
        stack_shape = (H // self.spec.tile_px, W // self.spec.tile_px)
        n_tiles = stack_shape[0] * stack_shape[1]
        z_indices, h = self._encode_networks(x, per_stream_networks)
        n_chunks = len(self.h_coder._chunk_batches(B))
        q = self.spec.quant_dim
        packed_bytes = 4 * B * int(h.shape[1]) * int(h.shape[2]) * q
        use_dev = self._use_device_encode(
            packed_bytes, n_chunks, (B, int(h.shape[1]), int(h.shape[2]), q))
        self._count_path(use_dev)

        def _z_all():
            z_np = z_indices.cpu().numpy()
            return [self.encode_z(z_np[b * n_tiles:(b + 1) * n_tiles])
                    for b in range(B)]

        if use_dev:
            t0 = time.perf_counter()
            h_streams, y_hat = self.h_coder.compress_device(h)
            self.router.note_device_encode(
                time.perf_counter() - t0, sum(len(s) for s in h_streams),
                packed_bytes, n_chunks)
            z_streams = _z_all()
        else:
            chunk_plans = self.h_coder.compress_plan_chunks(h)
            z_future = self._io.submit(_z_all)
            h_streams: list = [None] * B
            pending = []
            for start, real, packed_dev, _yh in chunk_plans:
                packed = self._fetch_packed(packed_dev)    # waits for this chunk
                pending.append((start, real, self._io.submit(
                    self.h_coder.encode_packed_many, packed)))
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
