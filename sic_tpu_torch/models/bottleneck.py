"""Detail-branch compressive bottleneck: transforms, four-part prior, and
the host driver of its real bitstream.

Counterpart of the JAX package's ``models/bottleneck.py`` (reference:
src/models/sq_bottleneck.py:55-253).  :class:`BottleneckCoder` runs the
4-step autoregressive chain: every step evaluates the prior CNN, derives the
step's CDF-index plane, and writes or reads the symbol plane with the host
coder or the device rANS kernels.  Encode and decode call the SAME step
functions at the SAME coding batch, so both sides walk bit-identical float
trajectories on one device (the float-trajectory contract): deterministic
kernels and no TF32 (see ``codec.configure_numerics``) are part of it.
"""
from __future__ import annotations

import copy
import functools
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..entropy import EntropyCoder, build_gaussian_tables
from ..entropy.fourpart import (add_uniform_noise, combine_for_writing,
                                forward_four_part_prior, four_part_masks,
                                process_with_mask, separate_prior)
from ..entropy.gaussian import build_indexes, gaussian_bits, lower_bound
from ..ops.rans_decode import (pack_substreams, rans_decode_plane,
                               split_substreams, words_tensor)
from ..ops.rans_encode import (encode_buffer_words, finalize_streams,
                               frame_substreams, initial_state,
                               rans_encode_plane, split_plane_rows)
from ..utils.profiling import timed_stage
from .dcvc import DepthConvBlock4
from .layers import Conv2d


class CompressiveBottleneck(nn.Module):
    """Analysis/synthesis transforms + learned prior over the detail latent;
    :meth:`forward` is the training pass, :class:`BottleneckCoder` the
    real bitstream."""

    def __init__(self, feat_dim: int, quant_dim: int, bpp_num: int = 1):
        super().__init__()
        f, q, b = feat_dim, quant_dim, bpp_num
        self.quant_dim = q
        self.enc_q = nn.Parameter(torch.ones(b, f))
        self.dec_q = nn.Parameter(torch.ones(b, f))
        self.factorized_prior_vec = nn.Parameter(torch.ones(b, q))
        self.enc_trans_0 = nn.ModuleList([DepthConvBlock4(f, f),
                                          DepthConvBlock4(f, f)])
        self.enc_trans_1 = nn.ModuleList([DepthConvBlock4(f, f),
                                          DepthConvBlock4(f, q)])
        self.dec_trans_0 = nn.ModuleList([DepthConvBlock4(q, f),
                                          DepthConvBlock4(f, f)])
        self.dec_trans_1 = nn.ModuleList([DepthConvBlock4(f, f),
                                          DepthConvBlock4(f, f)])
        self.y_prior_fusion = nn.ModuleList([DepthConvBlock4(q, q * 2),
                                             DepthConvBlock4(q * 2, q * 3)])
        self.y_spatial_prior_reduction = Conv2d(q * 3, q)
        self.y_spatial_prior_adaptors = nn.ModuleList(
            DepthConvBlock4(q * 2, q * 2) for _ in range(3))
        self.y_spatial_prior = nn.ModuleList(
            DepthConvBlock4(q * 2, q * 2) for _ in range(3))

    def encode_transform(self, y, q_idx: int = 0):
        for blk in self.enc_trans_0:
            y = blk(y)
        y = y * self.enc_q[q_idx]
        for blk in self.enc_trans_1:
            y = blk(y)
        return y

    def decode_transform(self, y_hat, q_idx: int = 0):
        for blk in self.dec_trans_0:
            y_hat = blk(y_hat)
        y_hat = y_hat * self.dec_q[q_idx]
        for blk in self.dec_trans_1:
            y_hat = blk(y_hat)
        return y_hat

    def prior_params(self, shape_bhw: Tuple[int, int, int], q_idx: int = 0):
        B, H, W = shape_bhw
        p = self.factorized_prior_vec[q_idx].expand(B, H, W, self.quant_dim)
        for blk in self.y_prior_fusion:
            p = blk(p)
        return p  # (B, H, W, 3*quant_dim)

    def reduce_common(self, common_params):
        return self.y_spatial_prior_reduction(common_params)

    def spatial_step(self, step: int, y_hat_so_far, common_reduced):
        p = torch.cat([y_hat_so_far, common_reduced], dim=-1)
        p = self.y_spatial_prior_adaptors[step - 1](p)
        for blk in self.y_spatial_prior:
            p = blk(p)
        scales, means = torch.chunk(p, 2, dim=-1)
        return scales, means

    def forward(self, y, img_hw: Tuple[int, int], q_idx: int = 0,
                training: bool = False, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                force_zero_thres: Optional[float] = None):
        """The fused four-step pass (training and bpp evaluation): returns
        (y_hat, {"y_hat", "bpp", "bpp_direct", "bpp_noise"}).  ``bpp_noise``
        is the differentiable noise-proxy rate, with uniform noise from
        ``noise`` or ``generator`` (neither: no noise); ``bpp_direct`` the
        hard-quant rate (reference: sq_bottleneck.py:140-156)."""
        y = self.encode_transform(y, q_idx)
        common = self.prior_params(tuple(y.shape[:3]), q_idx)
        step_fns = [functools.partial(self.spatial_step, i) for i in (1, 2, 3)]
        out = forward_four_part_prior(
            y, common, step_fns, reduction_fn=self.reduce_common,
            training=training,
            force_zero_thres=None if training else force_zero_thres)
        y_hat = self.decode_transform(out.y_hat, q_idx)
        pixel_num = img_hw[0] * img_hw[1]
        y_noise = out.y_res
        if noise is not None or generator is not None:
            y_noise = add_uniform_noise(out.y_res, generator, noise)
        bits_noise = gaussian_bits(y_noise, out.scales_hat, training=True)
        bpp_noise = torch.mean(torch.sum(bits_noise, dim=(1, 2, 3)) / pixel_num)
        bits_direct = gaussian_bits(out.y_q.detach(), out.scales_hat,
                                    training=training)
        bpp_direct = torch.mean(torch.sum(bits_direct, dim=(1, 2, 3)) / pixel_num)
        bpp = bpp_noise if training else bpp_direct
        return y_hat, {"y_hat": y_hat, "bpp": bpp, "bpp_direct": bpp_direct,
                       "bpp_noise": bpp_noise}


class BottleneckCoder:
    """Host driver: real bitstream compress/decompress for a bottleneck.

    ``probe`` arguments (a dict, optional) receive what a decode saw: the
    per-step CDF-index and symbol planes (CPU int32) and which entropy path
    ran.  They are how the tests and the chip check compare paths."""

    #: Canonical coding batch: every step of the coding chain runs at this
    #: batch size (chunks padded with zero images), on both sides of a
    #: stream.  Part of the coding contract; the file header carries it.
    CODING_BATCH = 8

    def __init__(self, module: CompressiveBottleneck,
                 force_zero_thres: Optional[float] = 0.12,
                 stream_part: int = 1, coding_batch: Optional[int] = None):
        self.module = module
        self.force_zero_thres = force_zero_thres
        self.stream_part = stream_part
        self.coding_batch = coding_batch or self.CODING_BATCH
        self.tables = build_gaussian_tables("gaussian")
        self.coder, self.cdf_group = self._new_coder()
        # the native coder is stateful: encode_packed holds this lock, and
        # concurrent decodes each check out their own decoder
        self.lock = threading.Lock()
        self._dec_pool: "queue.SimpleQueue" = queue.SimpleQueue()
        self._dec_pool.put((self.coder, self.cdf_group))
        self._enc_pool: "queue.SimpleQueue" = queue.SimpleQueue()
        self._dev_tables = {}

    @property
    def device(self) -> torch.device:
        return self.module.factorized_prior_vec.device

    def _new_coder(self):
        c = EntropyCoder(self.stream_part)
        g = c.add_cdf(self.tables.quantized_cdf, self.tables.cdf_length,
                      self.tables.offset)
        return c, g

    def _checkout_decoder(self):
        try:
            return self._dec_pool.get_nowait()
        except queue.Empty:
            return self._new_coder()

    def clone_with_stream_part(self, stream_part: int) -> "BottleneckCoder":
        """A shallow clone with its own native coders at another substream
        count, sharing the module and the tables (stream framing is host
        side only): reads legacy one-substream files beside a four-part
        runtime."""
        c = copy.copy(self)
        c.stream_part = stream_part
        c.coder, c.cdf_group = c._new_coder()
        c.lock = threading.Lock()
        c._dec_pool = queue.SimpleQueue()
        c._dec_pool.put((c.coder, c.cdf_group))
        c._enc_pool = queue.SimpleQueue()
        return c

    def _tables_on(self, device):
        key = str(device)
        if key not in self._dev_tables:
            t = self.tables
            # two threads may both build them: setdefault keeps one copy, so
            # every caller passes the same tensors (one packed kernel table)
            self._dev_tables.setdefault(key, tuple(
                torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
                for a in (t.quantized_cdf, t.cdf_length, t.offset)))
        return self._dev_tables[key]

    # -- the step functions shared by encode and decode ---------------------
    def _idx_of(self, scales, step: int):
        """Step's CDF-index plane (int16) from full scales."""
        H, W, C = scales.shape[1:]
        mask = four_part_masks(H, W, C, scales.dtype, scales.device)[step]
        plane = combine_for_writing(scales * mask)
        return build_indexes(plane, skip_thres=self.force_zero_thres).to(torch.int16)

    def _prior(self, shape_bhw, q_idx: int):
        """Prior eval + step-0 index plane."""
        common = self.module.prior_params(shape_bhw, q_idx)
        quant_step, scales, means = separate_prior(common)
        common_reduced = self.module.reduce_common(common)
        return (lower_bound(quant_step, 0.5), scales, means,
                common_reduced, self._idx_of(scales, 0))

    def _spatial_step(self, step: int, y_hat_so_far, common_reduced):
        scales, means = self.module.spatial_step(step, y_hat_so_far,
                                                 common_reduced)
        return scales, means, self._idx_of(scales, step)

    def _write_plane(self, y_div, scales, means, step: int):
        """Quantize step's positions -> symbol plane (int32)."""
        H, W, C = y_div.shape[1:]
        mask = four_part_masks(H, W, C, y_div.dtype, y_div.device)[step]
        _, y_q, _, _ = process_with_mask(y_div, scales, means, mask,
                                         self.force_zero_thres)
        return combine_for_writing(y_q).to(torch.int32)

    @staticmethod
    def _recon_step(sym_plane, means, step: int):
        """Scatter an integer plane back under the step mask, add means."""
        B, H, W, Cq = sym_plane.shape
        mask = four_part_masks(H, W, Cq * 4, means.dtype, means.device)[step]
        full = torch.cat([sym_plane.to(means.dtype)] * 4, dim=-1)
        return (full + means) * mask

    @staticmethod
    def _pack_planes(planes) -> torch.Tensor:
        """[(sym, idx) x 4] -> one (4, 2, B, H, W, C/4) int16 tensor (the
        int16 clamp is the native coder's symbol width), so the host path
        crosses to the host once."""
        return torch.stack([
            torch.stack([torch.clamp(s, -30000, 30000).to(torch.int16),
                         i.to(torch.int16)]) for s, i in planes])

    @staticmethod
    def _prep_rows(sym_plane, idx_plane, real: int, nparts: int):
        """(Bc, H, W, C/4) planes -> (real*nparts, n/nparts) int32 rows of
        the device encode, with the host path's int16 clamp."""
        s = torch.clamp(sym_plane[:real], -30000, 30000).to(torch.int32)
        return split_plane_rows(s.reshape(real, -1),
                                idx_plane[:real].to(torch.int32).reshape(real, -1),
                                nparts)

    def _chunk_batches(self, B: int, Bc: Optional[int] = None):
        """[(start, real count)] covering B images in coding-batch chunks."""
        Bc = Bc or self.coding_batch
        return [(s, min(Bc, B - s)) for s in range(0, B, Bc)]

    # -- encode ---------------------------------------------------------------
    @torch.no_grad()
    def _plan_chunk(self, yc, q_idx: int):
        """One coding-batch chunk of the encode chain: the 4-step prior walk
        giving the symbol/index planes and the simulated reconstruction.
        Shared by the host-coder and device-coder encodes, which must stay
        float-trajectory identical."""
        m = self.module
        y_t = m.encode_transform(yc, q_idx)
        quant_step, scales, means, common, idx0 = self._prior(
            tuple(y_t.shape[:3]), q_idx)
        y_div = y_t / quant_step
        y_hat_so_far = torch.zeros_like(y_div)
        planes = []
        for step in range(4):
            if step > 0:
                scales, means, idx = self._spatial_step(step, y_hat_so_far,
                                                        common)
            else:
                idx = idx0
            sym_plane = self._write_plane(y_div, scales, means, step)
            planes.append((sym_plane, idx))
            y_hat_so_far = y_hat_so_far + self._recon_step(sym_plane, means,
                                                           step)
        return planes, m.decode_transform(y_hat_so_far * quant_step, q_idx)

    def _plan_chunks(self, y, q_idx: int):
        """``[(start, real, planes, y_hat), ...]``: the encode chain of
        every coding-batch chunk, all enqueued on the device before any of
        it is read back (chunks padded with zero images)."""
        B = y.shape[0]
        Bc = self.coding_batch
        out = []
        for start, real in self._chunk_batches(B):
            yc = y[start:start + real]
            if real < Bc:
                pad = torch.zeros((Bc - real,) + tuple(y.shape[1:]),
                                  dtype=y.dtype, device=y.device)
                yc = torch.cat([yc, pad])
            planes, y_hat = self._plan_chunk(yc, q_idx)
            out.append((start, real, planes, y_hat[:real]))
        return out

    def compress_plan_chunks(self, y, q_idx: int = 0):
        """The encode chain per coding-batch chunk: ``[(start, real,
        packed (4, 2, real, H, W, C/4) int16 tensor, y_hat), ...]`` on the
        device.  Every chunk is enqueued before this returns, so a caller
        that reads chunk j back waits only for chunk j while the later
        chunks compute."""
        return [(start, real, self._pack_planes(planes)[:, :, :real], y_hat)
                for start, real, planes, y_hat in self._plan_chunks(y, q_idx)]

    def compress_plan(self, y, q_idx: int = 0):
        """One-shot form of :meth:`compress_plan_chunks`: ``(packed,
        y_hat)`` concatenated over the chunks."""
        chunks = self.compress_plan_chunks(y, q_idx)
        return (torch.cat([c[2] for c in chunks], dim=2),
                torch.cat([c[3] for c in chunks]))

    def can_compress_on_device(self, latent_shape) -> bool:
        """The device encoder needs each image's plane to split evenly into
        this coder's substreams; the runtime routes other shapes to the
        host coder before anything launches."""
        _B, H, W, C = latent_shape
        return (H * W * (C // 4)) % self.stream_part == 0

    def compress_device(self, y, q_idx: int = 0):
        """Device chain + device rANS encode (kernel 4): the symbol and
        index planes stay on the device and only the finished bytes come
        back.  Returns ``(streams, y_hat)`` with one framed stream per
        image, byte-identical to :meth:`encode_packed_many`.

        The emission buffer starts at :func:`encode_buffer_words` (2 bytes
        a position, where the JAX package stops and hands over to its host
        coder) and doubles on overflow, up to the worst case the escape
        rule allows (:func:`worst_case_bytes`); an overflow there is a bug
        and raises.  A plane that does not split into the substreams raises
        too: there is no host fallback here."""
        nparts = self.stream_part
        chunks = self._plan_chunks(y, q_idx)
        y_hat = torch.cat([c[3] for c in chunks])
        H, W, Cq = chunks[0][2][0][0].shape[1:]
        if not self.can_compress_on_device((1, H, W, 4 * Cq)):
            raise ValueError(f"a {H}x{W}x{Cq} plane does not split into "
                             f"{nparts} substreams; use the host coder")
        S = y.shape[0] * nparts
        npos = H * W * Cq // nparts
        rows = []
        for step in range(4):
            per_chunk = [self._prep_rows(planes[step][0], planes[step][1],
                                         real, nparts)
                         for _start, real, planes, _yh in chunks]
            rows.append((torch.cat([r[0] for r in per_chunk]).contiguous(),
                         torch.cat([r[1] for r in per_chunk]).contiguous()))
        cdf, cdf_len, cdf_off = self._tables_on(y.device)
        cap = -(-worst_case_bytes(4 * npos) // 4)
        nwords = min(cap, encode_buffer_words(4 * npos))
        while True:
            words = torch.zeros((S, nwords), dtype=torch.int32, device=y.device)
            state = initial_state(S, y.device)
            for step in (3, 2, 1, 0):           # last in, first out
                with timed_stage(None, "h_rans.step"):
                    words, state = rans_encode_plane(*rows[step], words, state,
                                                     cdf, cdf_len, cdf_off)
            with timed_stage(None, "h_rans.fetch"):
                state_np = state.cpu().numpy()
            if not state_np[:, 2].any():
                break
            if nwords >= cap:
                raise RuntimeError(
                    f"rANS encode overflowed its worst-case buffer of {cap} "
                    f"words per substream")
            nwords = min(2 * nwords, cap)
        with timed_stage(None, "h_rans.fetch"):
            words_np = words.cpu().numpy()
        parts = finalize_streams(words_np, state_np, S)
        streams = [frame_substreams(parts[b * nparts:(b + 1) * nparts])
                   for b in range(y.shape[0])]
        return streams, y_hat

    def encode_packed(self, packed) -> bytes:
        """Host rANS over a packed-planes array (one stream for the whole
        batch)."""
        packed = _host(packed)
        with self.lock, timed_stage(None, "h_rans.code"):
            self.coder.reset()
            for step in range(packed.shape[0]):
                self.coder.encode_with_indexes(packed[step, 0], packed[step, 1],
                                               self.cdf_group)
            self.coder.flush()
            return self.coder.get_encoded_stream()

    def encode_packed_many(self, packed, workers: int = 8) -> list:
        """One stream per image of a batched packed array (4, 2, B, ...):
        the images fan out over at most ``min(workers, cpu count, B)``
        threads, each coding with a native encoder of its own from the
        encoder pool (the ctypes calls release the GIL), as the JAX
        package's ``encode_packed_many`` does.  With one image or one
        worker the images go one after another through
        :meth:`encode_packed`.  The streams do not depend on ``workers``."""
        packed = _host(packed)
        B = packed.shape[2]
        workers = min(workers, os.cpu_count() or 1, B)
        if B == 1 or workers <= 1:
            return [self.encode_packed(packed[:, :, b:b + 1]) for b in range(B)]

        def _enc(b):
            try:
                coder, group = self._enc_pool.get_nowait()
            except queue.Empty:
                coder, group = self._new_coder()
            try:
                with timed_stage(None, "h_rans.code"):
                    coder.reset()
                    for step in range(packed.shape[0]):
                        coder.encode_with_indexes(packed[step, 0, b:b + 1],
                                                  packed[step, 1, b:b + 1], group)
                    coder.flush()
                    return coder.get_encoded_stream()
            finally:
                self._enc_pool.put((coder, group))

        with ThreadPoolExecutor(max_workers=workers) as pool, \
                timed_stage(None, "h_rans.code"):
            return list(pool.map(_enc, range(B)))

    def compress(self, y, q_idx: int = 0):
        """y: (B, H, W, feat_dim) -> (one host-coded stream for the batch,
        y_hat)."""
        packed, y_hat = self.compress_plan(y, q_idx)
        return self.encode_packed(packed), y_hat

    # -- decode ---------------------------------------------------------------
    @torch.no_grad()
    def _run_decode_chain(self, feat_shape, q_idx, get_symbols,
                          coding_batch: Optional[int] = None, probe=None):
        """Shared 4-step autoregressive decode driver.  The chain runs at
        the coding batch (pad images are zeros and consume no stream
        bytes); ``get_symbols(step, idx_c, chunks, Bc)`` supplies each
        chunk's Bc-padded symbol plane on the device."""
        m = self.module
        B, H, W, C = feat_shape
        Bc = coding_batch or self.coding_batch
        chunks = self._chunk_batches(B, Bc)
        quant_step, _scales, means0, common, idx0 = self._prior((Bc, H, W), q_idx)
        y_hats = [torch.zeros((Bc, H, W, C), dtype=quant_step.dtype,
                              device=quant_step.device) for _ in chunks]
        means_c = [means0] * len(chunks)
        idx_c = [idx0] * len(chunks)
        for step in range(4):
            with timed_stage(None, "h_rans.step"):
                if step > 0:
                    for ci in range(len(chunks)):
                        _s, means_c[ci], idx_c[ci] = self._spatial_step(
                            step, y_hats[ci], common)
                sym_chunks = get_symbols(step, idx_c, chunks, Bc)
                if probe is not None:
                    probe.setdefault("index_planes", []).append(torch.cat(
                        [a[:real] for a, (_s, real) in zip(idx_c, chunks)]
                    ).int().cpu())
                    probe.setdefault("symbol_planes", []).append(torch.cat(
                        [a[:real] for a, (_s, real) in zip(sym_chunks, chunks)]
                    ).int().cpu())
                for ci in range(len(chunks)):
                    y_hats[ci] = y_hats[ci] + self._recon_step(
                        sym_chunks[ci], means_c[ci], step)
        outs = [m.decode_transform(yh * quant_step, q_idx)[:real]
                for yh, (_s, real) in zip(y_hats, chunks)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def decompress(self, bit_stream: bytes, feat_shape, q_idx: int = 0,
                   coding_batch: Optional[int] = None, probe=None):
        """Host-coder decode.  feat_shape: (B, H, W, quant_dim) of the
        coded latent; ``coding_batch``: the stream's coding contract."""
        coder, group = self._checkout_decoder()
        dev = self.device

        def get_symbols(step, idx_c, chunks, Bc):
            with timed_stage(None, "h_rans.fetch"):
                idx_np = [a.cpu().numpy() for a in idx_c]  # one transfer round
            idx_real = np.concatenate(
                [a[:real] for a, (_s, real) in zip(idx_np, chunks)])
            with timed_stage(None, "h_rans.code"):
                sym_np = coder.decode_stream(idx_real, group).reshape(idx_real.shape)
            out, off = [], 0
            for _start, real in chunks:
                sp = np.zeros((Bc,) + sym_np.shape[1:], np.int16)
                sp[:real] = sym_np[off:off + real]
                off += real
                out.append(torch.from_numpy(sp).to(dev))
            return out

        try:
            coder.set_stream(bit_stream)
            if probe is not None:
                probe["h_path"] = "host"
            return self._run_decode_chain(feat_shape, q_idx, get_symbols,
                                          coding_batch, probe)
        finally:
            self._dec_pool.put((coder, group))

    @staticmethod
    def can_decompress_on_device(bit_stream: bytes, feat_shape) -> bool:
        """The device decoder needs the plane to split evenly into the
        stream's substreams."""
        if len(bit_stream) < 1:
            return False
        nparts = (bit_stream[0] >> 4) + 1
        B, H, W, C = feat_shape
        n_step = B * H * W * (C // 4)
        return n_step % nparts == 0 and (n_step // nparts) >= 1

    def decompress_device(self, bit_stream: bytes, feat_shape, q_idx: int = 0,
                          coding_batch: Optional[int] = None, probe=None):
        """Device-resident decode: each step chains prior CNN -> rANS plane
        kernel -> reconstruction on the device; the stream crosses to the
        device once and the symbols never come back to the host."""
        B, H, W, C = feat_shape
        dev = self.device
        parts = split_substreams(bit_stream)
        nparts = len(parts)
        if (B * H * W * (C // 4)) % nparts:
            raise ValueError("substream count does not evenly divide plane")
        words_np, lens_np, state_np = pack_substreams(parts)
        words = words_tensor(words_np, dev)
        lens = torch.from_numpy(lens_np.reshape(-1)).to(dev)
        cdf, cdf_len, cdf_off = self._tables_on(dev)
        state = {"st": torch.from_numpy(state_np).to(dev)}

        def get_symbols(step, idx_c, chunks, Bc):
            idx_real = torch.cat([a[:real] for a, (_s, real)
                                  in zip(idx_c, chunks)])
            # substream p holds the p-th contiguous part of the plane
            rows = idx_real.to(torch.int32).reshape(nparts, -1).contiguous()
            sym, state["st"] = rans_decode_plane(
                rows, words, lens, state["st"], cdf, cdf_len, cdf_off)
            sym_plane = sym.reshape(idx_real.shape)
            out = []
            for start, real in chunks:
                sp = sym_plane[start:start + real]
                if real < Bc:
                    sp = torch.cat([sp, torch.zeros(
                        (Bc - real,) + tuple(sp.shape[1:]), dtype=sp.dtype,
                        device=dev)])
                out.append(sp)
            return out

        if probe is not None:
            probe["h_path"] = "device"
        return self._run_decode_chain(feat_shape, q_idx, get_symbols,
                                      coding_batch, probe)

    def decompress_batched(self, bit_streams, latent_shape, q_idx: int = 0,
                           workers: int = 8, coding_batch: Optional[int] = None,
                           probe=None):
        """Decode B independent per-image streams with BATCHED device steps
        (4 host syncs in all), one pooled host decoder per stream; each
        step's per-image host rANS decodes fan out over at most
        ``min(workers, cpu count, B)`` threads (one after another with one
        image or one worker), as in the JAX package, whose positions the
        arguments keep (``probe``, the port's own, comes last).
        ``latent_shape``: (1, H, W, quant_dim) shared by every stream.
        y_hat does not depend on ``workers``."""
        B = len(bit_streams)
        _, H, W, C = latent_shape
        workers = min(workers, os.cpu_count() or 1, B)
        coders = [self._checkout_decoder() for _ in bit_streams]
        dev = self.device

        def make_get_symbols(pool):
            def get_symbols(step, idx_c, chunks, Bc):
                with timed_stage(None, "h_rans.fetch"):
                    idx_np = [a.cpu().numpy() for a in idx_c]  # one round for all B

                def _dec(i):
                    coder, group = coders[i]
                    ci, off = divmod(i, Bc)
                    return coder.decode_stream(idx_np[ci][off], group)

                def _dec_on_pool(i):
                    with timed_stage(None, "h_rans.code"):
                        return _dec(i)

                # one span on this thread, waiting for the pool or decoding
                with timed_stage(None, "h_rans.code"):
                    syms = list(pool.map(_dec_on_pool, range(B)) if pool is not None
                                else map(_dec, range(B)))
                out = []
                for ci, (start, real) in enumerate(chunks):
                    sp = np.zeros((Bc,) + idx_np[ci].shape[1:], np.int16)
                    for off in range(real):
                        sp[off] = syms[start + off].reshape(sp.shape[1:])
                    out.append(torch.from_numpy(sp).to(dev))
                return out
            return get_symbols

        try:
            for (coder, _g), stream in zip(coders, bit_streams):
                coder.set_stream(stream)
            if probe is not None:
                probe["h_path"] = "host"
            if B == 1 or workers <= 1:
                return self._run_decode_chain((B, H, W, C), q_idx,
                                              make_get_symbols(None),
                                              coding_batch, probe)
            with ThreadPoolExecutor(max_workers=workers) as pool:
                return self._run_decode_chain((B, H, W, C), q_idx,
                                              make_get_symbols(pool),
                                              coding_batch, probe)
        finally:
            for item in coders:
                self._dec_pool.put(item)

    # -- the reference's ablation helpers (sq_bottleneck.py:202-253) -------------
    @torch.no_grad()
    def entropy_map(self, y, q_idx: int = 0) -> torch.Tensor:
        """Per-element hard-quant bit map of the transformed latent
        (reference: sq_bottleneck.py:219-232)."""
        m = self.module
        y_t = m.encode_transform(y, q_idx)
        common = m.prior_params(tuple(y_t.shape[:3]), q_idx)
        step_fns = [functools.partial(m.spatial_step, i) for i in (1, 2, 3)]
        out = forward_four_part_prior(y_t, common, step_fns,
                                      reduction_fn=m.reduce_common, training=False,
                                      force_zero_thres=self.force_zero_thres)
        return gaussian_bits(out.y_q, out.scales_hat, training=False)

    def compress_decompress(self, y, img_hw, q_idx: int = 0):
        """Round trip through a real stream with the reference's validity
        contract (reference: sq_bottleneck.py:202-216): the decoded y_hat
        must equal the encoder's, else AssertionError.  Returns (y_hat,
        {"y_hat", "bpp", "bit_stream", "bpp_est", "bpp_diff"})."""
        B, H, W, _ = y.shape
        stream, y_hat_enc = self.compress(y, q_idx)
        y_hat = self.decompress(stream, (B, H, W, self.module.quant_dim), q_idx)
        if float(torch.sum(torch.abs(y_hat - y_hat_enc))) != 0.0:
            raise AssertionError("entropy-coded reconstruction diverged from "
                                 "encoder simulation")
        bpp = len(stream) * 8 / (img_hw[0] * img_hw[1])
        with torch.no_grad():
            _, est = self.module(y, tuple(img_hw), q_idx,
                                 force_zero_thres=self.force_zero_thres)
        bpp_est = float(est["bpp"])
        return y_hat, {"y_hat": y_hat, "bpp": bpp, "bit_stream": stream,
                       "bpp_est": bpp_est, "bpp_diff": bpp - bpp_est}

    def compress_decompress_entropy_map(self, y, img_hw, q_idx: int = 0):
        """:meth:`compress_decompress` with the bit map under
        ``"entropy_map"`` (reference: sq_bottleneck.py:234-253)."""
        emap = self.entropy_map(y, q_idx)
        y_hat, info = self.compress_decompress(y, img_hw, q_idx)
        info["entropy_map"] = emap
        return y_hat, info


def worst_case_bytes(npos: int) -> int:
    """Most bytes one substream can emit for ``npos`` coded positions.

    A position codes one symbol of at most 16 bits (its frequency is at
    least 1 of 2^16) and, if it escapes, count entries and 2-bit bypass
    chunks of 2 bits each.  Symbols are clamped to +-30000 and table
    offsets lie in [-50, -2], so a bypass value stays below 2^16: at most
    8 chunks and 3 count entries (8 = 3 + 3 + 2), 38 bits in all.
    Renormalisation adds under 0.012 bit a symbol (the state is then at
    least freq * 2^7, so rounding grows it by a factor under 1 + 2^-7),
    and the state starts at 2^23 and never drops below it, so the bytes
    emitted stay under 38.012 / 8 = 4.752 a position: 5 a position, plus
    4, is a safe cap."""
    return 5 * npos + 4


def _host(packed) -> np.ndarray:
    """Packed planes on the host (a device tensor is copied back once)."""
    return packed.cpu().numpy() if isinstance(packed, torch.Tensor) \
        else np.asarray(packed)
