"""Top-level codec, decode side, and its deployment runtime.

Counterpart of the JAX package's ``models/codec.py`` (reference:
src/models/codec_sq_fixbpp.py:442-922).  :class:`Codec` holds the decode
modules; :class:`CodecRuntime` decodes real bitstreams: the semantic (TiTok
token) stream through a uniform-CDF rANS coder, the detail (h) stream
through the bottleneck's autoregressive chain on the host coder or on the
device rANS kernel, then the generative decode to pixels.
"""
from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import CodecSpec
from ..entropy import EntropyCoder
from .bottleneck import BottleneckCoder
from .hybrid import FeatMerge, HybridCodec
from .vqgan import VQGAN


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


class Codec(nn.Module):
    """Hybrid decoder + VQGAN pixel decoder + prior fusion (decode side;
    parameter names mirror the JAX package's tree)."""

    def __init__(self, spec: CodecSpec):
        super().__init__()
        s = spec
        self.spec = spec
        self.hybrid_codec = HybridCodec(s.titok, s.insert_pos_dec, s.feat_width,
                                        s.quant_dim, s.num_attns)
        self.vqgan = VQGAN(s.vqgan)
        self.prior_fusion = FeatMerge(s.titok.width, s.feat_width,
                                      s.vqgan.n_embed, s.merge_inner_width)

    def decode_to_latent(self, titok_hat, feat_hat):
        """Soft codebook mixture from fused logits
        (reference: codec_sq_fixbpp.py:658-663)."""
        logits = self.prior_fusion(titok_hat, feat_hat)
        probs = torch.softmax(logits.float(), dim=-1)
        latent = torch.matmul(probs, self.vqgan.quantize.codebook())
        return latent.to(logits.dtype), logits

    def decode_to_image(self, quantized_latent):
        return self.vqgan.decode(quantized_latent)

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


class CodecRuntime:
    """Host driver of the real-bitstream decode (reference:
    codec_sq_fixbpp.py:849-922).

    ``device_entropy``: ``"auto"`` decodes the h stream with the device
    rANS kernel on CUDA when the stream has >= 4 substreams, else with the
    host coder; ``"device"`` forces the kernel path (on the CPU: its plain
    version), ``"host"`` the host coder."""

    def __init__(self, spec: CodecSpec, model: Codec, stream_part: int = 1,
                 device_entropy: str = "auto"):
        if device_entropy not in ("auto", "host", "device"):
            raise ValueError(f"device_entropy: {device_entropy}")
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
        # host-side z decoding overlaps the h decode
        self._io = ThreadPoolExecutor(max_workers=4, thread_name_prefix="sic-z")

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
        """Semantic-token indices -> rANS stream (uniform CDF)."""
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
            raise NotImplementedError(
                "torchac-coded semantic streams (reference-produced .c2df "
                "files) are not supported by the PyTorch port yet; re-encode "
                "with z_coder='rans'")
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

    def decode_only_batched(self, enc_results, output: str = "float",
                            probe: Optional[Dict] = None) -> torch.Tensor:
        """Same-shaped streams decoded together: the 4 autoregressive steps
        run device-batched over all B streams with one host coder each.
        Returns x_hat (B, H, W, 3)."""
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
        return self._decode_pixels(z, h_hat, first["stack_shape"], output)

    # -- encode of the detail stream (host coder) -----------------------------
    def encode_features(self, y: torch.Tensor, stack_shape: Tuple[int, int],
                        z_indices: np.ndarray) -> list:
        """Bitstreams for given detail features and semantic tokens, one
        per image: y (B, H/32, W/32, feat_width) on the device, z_indices
        (B * tiles, n_latent) int.  The pixel encoder is not ported yet;
        this is the bottleneck's host encode the decoder must invert.
        Returns ``decode_only`` keyword dicts with ``y_hat`` (the encoder's
        reconstruction, which a decode must reproduce bit for bit)."""
        B, Hf, Wf, _ = y.shape
        n_tiles = stack_shape[0] * stack_shape[1]
        tp = self.spec.tile_px
        out = []
        for start, real, packed, y_hat in self.h_coder.compress_plan_chunks(y):
            streams = self.h_coder.encode_packed_many(packed)
            for k, stream in enumerate(streams):
                b = start + k
                z = z_indices[b * n_tiles:(b + 1) * n_tiles]
                out.append({
                    "z_bit_stream": self.encode_z(z),
                    "h_bit_stream": stream,
                    "img_shape": (stack_shape[0] * tp, stack_shape[1] * tp),
                    "feat_shape": (1, Hf, Wf, int(y.shape[-1])),
                    "stack_shape": tuple(stack_shape),
                    "token_length": int(z.size),
                    "z_indices_shape": tuple(z.shape),
                    "y_hat": y_hat[k:k + 1],
                })
        return out
