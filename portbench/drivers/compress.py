"""Corpus compress: a closed loop of the compress CLI's per-batch work
(``cli/compress.py``) without files: ``encode_only_batched`` on a batch
of seeded images, then per image the CLIP image tower's
``image_to_unit_vec``, ``quantize_u8_and_compress``, the header and
``pack_c2df``.

Traffic keys: ``image_hw``, ``pool`` (distinct images), ``batch``,
``sample`` (archives of the window the reference decodes whole, and whose
CLIP vectors it computes), ``z_sample`` (archives whose semantic ids it
reads, against its own encode of the images), ``limits``.

The archives of both samples are drawn from the seed as the window runs
(``harness.sample.Reservoir``), and only they are kept.  The check: the
reference reads each sampled archive with its own parser and decoders
(every substream must end where its encoder began), encodes the same
input image with its own fp32 networks, and compares the semantic ids of
the tokens it places surely and the CLIP vector.  The detail stream's
symbols are not compared: the control strays from fp32 there no further
than bf16 does (PERF.md, section 2)."""
from __future__ import annotations

import numpy as np
import torch

from ..harness.images import make_images
from ..harness.sample import Reservoir
from ..harness.weights import init_seeded
from ..reference.bottleneck import CODING_BATCH
from . import _codec

SEED_MOD = 1 << 63
# a token whose nearest code wins by more than this (in the quantizer's
# score, 2 z.c - |c|^2 on unit vectors) does not flip under bf16 rounding;
# nearer ties do, under any precision (PERF.md, section 2)
SURE = 0.01


class Driver:
    def __init__(self, run, quant=None):
        from sic_tpu_torch.retrieval import ClipCodec
        self.run = run
        t = run.traffic
        self.batch = int(t["batch"])
        self.hw = tuple(t["rehearsal_hw"] if run.tiny else t["image_hw"])
        clock = _codec.Clock()
        self.images = make_images(np.random.default_rng([run.seed, 0]),
                                  int(t["pool"]), self.hw)
        clock.lap("images")
        self.rt = _codec.program_runtime(run, quant=quant)
        self.clip = ClipCodec(device=run.device)
        init_seeded(self.clip.model, (run.seed + 2) % SEED_MOD)
        clock.lap("runtime")
        self.order_rng = np.random.default_rng([run.seed, 1])
        self.queue = []
        # (image id, archive, CLIP vector) of the archives the check reads
        self.kept = {key: Reservoir(int(t[key]), np.random.default_rng([run.seed, stream]))
                     for key, stream in (("sample", 2), ("z_sample", 3))}
        self.step(record=False)      # warm the batch's shapes
        self.counts0 = dict(self.rt.encode_path_counts)
        clock.lap("warm")

    def _next_ids(self):
        if len(self.queue) < self.batch:
            self.queue.extend(self.order_rng.permutation(len(self.images)).tolist())
        ids, self.queue = self.queue[:self.batch], self.queue[self.batch:]
        return ids

    def step(self, record: bool = True) -> int:
        from sic_tpu_torch.cli.compress import c2df_header
        from sic_tpu_torch.container import pack_c2df
        ids = self._next_ids()
        imgs = self.images[ids]
        encs = self.rt.encode_only_batched(torch.from_numpy(imgs))
        for i, img, enc in zip(ids, imgs, encs):
            vec = self.clip.image_to_unit_vec(img)
            enc["clip_stream"], meta = self.clip.quantize_u8_and_compress(vec)
            enc["clip_meta"] = meta
            header = c2df_header(self.rt, meta, img.shape[:2], (0, 0, 0, 0))
            archive = pack_c2df(enc, header)
            if record:
                for kept in self.kept.values():
                    slot = kept.wants()
                    if slot is not None:
                        kept.keep(slot, (i, archive, vec))
        return len(ids)

    def counters(self) -> dict:
        return {k: v - self.counts0.get(k, 0)
                for k, v in self.rt.encode_path_counts.items()}

    def release(self) -> None:
        self.rt.close()
        del self.rt, self.clip
        _codec.free_cuda()

    def sample(self, key: str = "sample"):
        """The ``traffic[key]`` archives of the window drawn from the seed."""
        return self.kept[key].items()

    def _z_of(self, encs) -> np.ndarray:
        """The semantic ids the reference reads from each archive's stream."""
        from ..reference.codec import decode_z
        K = self.rt_spec_codebook
        return np.concatenate([decode_z(e["z_bit_stream"], e["token_length"], K)[0]
                               for e in encs])

    def _x01(self, ids):
        return torch.from_numpy(self.images[ids]).to(self.run.device) * 0.5 + 0.5

    @staticmethod
    def _desynced(dec, archives_or_encs) -> int:
        """The substreams the reference's decode of archives (or container
        fields) leaves short of their encoder's start state."""
        from ..reference.c2df import unpack_c2df
        encs = []
        for a in archives_or_encs:
            if isinstance(a, dict):
                enc = a
            else:
                enc, header = unpack_c2df(a)
                enc["coding_batch"] = int(header["coding_batch"])
            encs.append(enc)
        dec.decode(encs)
        return dec.desynced

    def _reference(self, picked, zpicked):
        """The reference's reading of the archives (its parser, its
        decoders) and its own fp32 encode of the same images: semantic
        ids, each token's margin, the CLIP vectors."""
        from ..reference.c2df import unpack_c2df
        from ..reference.codec import Decoder
        model = _codec.reference_codec(self.run)
        self.rt_spec_codebook = model.spec.titok.codebook_size
        dec = Decoder(model)
        desync = self._desynced(dec, [a for _i, a, _v in picked])
        z_dec = self._z_of([unpack_c2df(a)[0] for _i, a, _v in zpicked])
        z_ref, margins = [], []
        ids = [i for i, _a, _v in zpicked]
        for b in range(0, len(ids), 8):
            x01 = self._x01(ids[b:b + 8])
            with torch.no_grad():
                z_ref.append(model.encode_stage(x01)[0].cpu().numpy().reshape(-1))
                margins.append(model.token_margins(x01).cpu().numpy())
        del dec, model
        _codec.free_cuda()
        self._ref = (np.concatenate(z_ref), np.concatenate(margins),
                     self._clip_vectors(picked, tf32=False))
        return z_dec, desync

    def _clip_vectors(self, picked, tf32: bool):
        from ..reference.clip_model import CLIPModel, preprocess_image
        from .generate import tf32 as tf32_block
        with torch.device(self.run.device):
            clip = CLIPModel()
        init_seeded(clip, (self.run.seed + 2) % SEED_MOD)
        clip.eval().requires_grad_(False)
        x = np.stack([preprocess_image(self.images[i], clip.spec.image_size)
                      for i, _a, _v in picked])
        with torch.no_grad(), tf32_block(tf32):
            vecs = clip.encode_image(torch.from_numpy(x).to(self.run.device)).cpu().numpy()
        del clip
        _codec.free_cuda()
        return vecs

    def _numbers(self, z_dec, desync, vecs) -> dict:
        """Streams that do not decode back (exact); the share of the
        tokens the reference places with a margin over ``SURE`` that the
        program coded otherwise; the widest CLIP difference."""
        z_ref, margins, vec_ref = self._ref
        sure = margins > SURE
        flips = z_dec.reshape(-1)[sure] != z_ref[sure]
        return {"stream_desync": float(desync),
                "z_flip_sure_pct": float(100.0 * flips.mean()) if sure.any() else 0.0,
                "clip_max_abs": float(np.abs(np.asarray(vecs) - vec_ref).max())}

    def check(self) -> dict:
        picked = self.sample()
        z_dec, desync = self._reference(picked, self.sample("z_sample"))
        return self._numbers(z_dec, desync, [v for _i, _a, v in picked])

    def control_check(self) -> dict:
        """The controls: the program's int8 W8A8 path encoding the sampled
        images (the codec's bf16 stated, int8 below it), and the
        reference's CLIP tower in TF32 (its fp32 stated, TF32 below it),
        judged against the same reference readings."""
        from ..reference.codec import Decoder
        picked, zpicked = self.sample(), self.sample("z_sample")
        rt = _codec.program_runtime(self.run, quant="int8")

        def encode(ids):
            encs = [e for b in range(0, len(ids), 8)
                    for e in rt.encode_only_batched(torch.from_numpy(self.images[ids[b:b + 8]]))]
            for e in encs:
                e["coding_batch"] = CODING_BATCH
            return encs
        zencs = encode([i for i, _a, _v in zpicked])
        encs = encode([i for i, _a, _v in picked])
        rt.close()
        del rt
        _codec.free_cuda()
        z_dec = self._z_of(zencs)
        dec = Decoder(_codec.reference_codec(self.run))
        desync = self._desynced(dec, encs)
        del dec
        _codec.free_cuda()
        return self._numbers(z_dec, desync, self._clip_vectors(picked, tf32=True))

    def counts(self):
        from ..harness.counts import codec_encode_counts
        from ..reference.clip_model import CLIPModel
        with torch.device("meta"):
            clip = CLIPModel().eval().requires_grad_(False)
        x = torch.zeros((1, clip.spec.image_size, clip.spec.image_size, 3), device="meta")
        return codec_encode_counts(self.run, lambda: clip.encode_image(x))
