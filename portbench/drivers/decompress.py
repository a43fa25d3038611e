"""Corpus decompress: a closed loop of device batches of same-shaped
``.c2df`` archives through the decompress CLI's per-bucket work
(``unpack_c2df``, then ``CodecRuntime.decode_only_batched(..., output="u8")``
and the pixels on the host).

Traffic keys: ``image_hw``, ``pool`` (distinct images, encoded by the
program in set-up from seeded tiles), ``batch``, ``sample`` (stream
decodes of the window that the reference decodes again), ``limits``.

The sampled decodes are drawn from the seed as the window runs
(``harness.sample.Reservoir``), and only they are kept.  The check: the
reference parses each sampled archive and decodes it with its own entropy
decoders (every substream must end where its encoder began) and networks;
the semantic ids the program decoded in that decode must equal the
reference's (the runtime's ``_decode_z`` is wrapped to see them: with
seeded weights a wrong id barely moves the pixels), and the pixels must
stray from the fp32 reference's no further than bf16 arithmetic does
(``_codec.tail_ratio``)."""
from __future__ import annotations

import numpy as np
import torch

from ..harness.images import make_images
from ..harness.sample import Reservoir
from . import _codec


class Driver:
    def __init__(self, run, quant=None):
        from sic_tpu_torch.cli.compress import c2df_header
        from sic_tpu_torch.container import pack_c2df
        self.run = run
        t = run.traffic
        self.batch = int(t["batch"])
        hw = tuple(t["rehearsal_hw"] if run.tiny else t["image_hw"])
        rng = np.random.default_rng([run.seed, 0])
        clock = _codec.Clock()
        self.images = make_images(rng, int(t["pool"]), hw)
        clock.lap("images")
        self.rt = _codec.program_runtime(run, quant=quant)
        self.z_step = []             # the ids of this step's decodes, in order
        decode_z = self.rt._decode_z

        def seen(stream, n, coder):
            ids = decode_z(stream, n, coder)
            self.z_step.append(ids)
            return ids
        self.rt._decode_z = seen
        clock.lap("runtime")
        self.archives = []
        for s in range(0, len(self.images), self.batch):
            x = torch.from_numpy(self.images[s:s + self.batch])
            for enc in self.rt.encode_only_batched(x):
                header = c2df_header(self.rt, {}, hw, (0, 0, 0, 0))
                self.archives.append(pack_c2df(enc, header))
        self.order_rng = np.random.default_rng([run.seed, 1])
        self.queue = []
        # (archive id, u8 pixels, semantic ids) of the sampled decodes
        self.kept = Reservoir(int(t["sample"]), np.random.default_rng([run.seed, 2]))
        clock.lap("encode pool")
        self.step(record=False)      # warm the batch's shapes
        clock.lap("warm")

    def _next_ids(self):
        if len(self.queue) < self.batch:
            self.queue.extend(self.order_rng.permutation(len(self.archives)).tolist())
        ids, self.queue = self.queue[:self.batch], self.queue[self.batch:]
        return ids

    def step(self, record: bool = True) -> int:
        from sic_tpu_torch.container import sanitize_enc_result_types, unpack_c2df
        ids = self._next_ids()
        encs = []
        for i in ids:
            enc, header = unpack_c2df(self.archives[i])
            enc = sanitize_enc_result_types(enc)
            enc["z_coder"] = header.get("z_coder", "torchac")
            enc["coding_batch"] = int(header.get("coding_batch", 1))
            encs.append(enc)
        self.z_step = []
        px = self.rt.decode_only_batched(encs, output="u8").cpu()
        if record:
            # a decode that read its ids elsewhere than ``_decode_z`` shows
            # none, and fails the check
            z = self.z_step if len(self.z_step) == len(ids) else [None] * len(ids)
            for k, i in enumerate(ids):
                slot = self.kept.wants()
                if slot is not None:
                    self.kept.keep(slot, (i, px[k].clone(),
                                          None if z[k] is None else np.array(z[k], copy=True)))
        return len(ids)

    def counters(self) -> dict:
        return {}

    def release(self) -> None:
        self.rt.close()
        del self.rt
        _codec.free_cuda()

    def _reference(self):
        """The sampled decodes and the reference's pixels of them (its own
        parse of the archives, its own entropy decode and networks)."""
        from ..reference.c2df import unpack_c2df
        from ..reference.codec import Decoder
        picked = self.kept.items()
        ref = Decoder(_codec.reference_codec(self.run))
        encs = []
        for i, _px, _z in picked:
            enc, header = unpack_c2df(self.archives[i])
            enc["coding_batch"] = int(header["coding_batch"])
            encs.append(enc)
        ref_px, z_ref, _planes = ref.decode(encs)
        desync = float(ref.desynced)
        # the ids the program decoded in each sampled decode against the
        # reference's reading of the same stream
        self._z_mismatch = float(sum(
            want.size if ids is None else int((np.asarray(ids).reshape(-1) != want).sum())
            for want, (_i, _px, ids) in zip(z_ref.reshape(len(encs), -1), picked)))
        ref.model.compute_in(torch.bfloat16)
        ref16_px = ref.pixels()
        del ref
        _codec.free_cuda()
        return picked, ref_px.numpy(), desync, ref16_px.numpy()

    def _numbers(self, prog):
        _picked, ref_px, desync, ref16_px = self._ref
        return {"stream_desync": desync, "z_mismatch": self._z_mismatch,
                "pixel_tail8_ratio": _codec.tail_ratio(prog, ref16_px, ref_px, 8)}

    def check(self) -> dict:
        self._ref = self._reference()
        return self._numbers(np.stack([px.numpy() for _i, px, _z in self._ref[0]]))

    def control_check(self) -> dict:
        """The control: the program's own int8 W8A8 path (the precision
        below the configuration's bf16) decoding the sampled archives,
        against the same reference pixels."""
        from sic_tpu_torch.container import sanitize_enc_result_types, unpack_c2df
        picked = self._ref[0]
        rt = _codec.program_runtime(self.run, quant="int8")
        out = []
        for s in range(0, len(picked), self.batch):
            encs = []
            for i, _px, _z in picked[s:s + self.batch]:
                enc, header = unpack_c2df(self.archives[i])
                enc = sanitize_enc_result_types(enc)
                enc["z_coder"] = header.get("z_coder", "torchac")
                enc["coding_batch"] = int(header.get("coding_batch", 1))
                encs.append(enc)
            out.append(rt.decode_only_batched(encs, output="u8").cpu().numpy())
        rt.close()
        del rt
        _codec.free_cuda()
        return self._numbers(np.concatenate(out))

    def counts(self):
        from ..harness.counts import codec_decode_counts
        return codec_decode_counts(self.run)
