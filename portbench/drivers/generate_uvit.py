"""Class-conditional generation through the U-ViT generator (TiTok-S-128's):
the loop of ``generate.py`` (seeded class labels a batch through the
port's ``models.maskgit.generate`` and ``TiTok.decode_tokens``, ranges
``portbench.generate`` and ``portbench.decode_tokens``) with the port's
``models.maskgit_uvit.UViTGenerator`` and the configuration's sampling:
its guidance schedule (power-cosine: both passes at every step) and
softmax-temperature annealing.

Traffic keys: those of ``generate.py``.  The check is ``generate.py``'s,
along each sampled trajectory, with the reference's guided logits under
the configuration's schedule and annealing
(``reference.maskgit_uvit.guided_logits``)."""
from __future__ import annotations

import numpy as np
import torch

from ..harness.sample import Reservoir
from . import generate as base


def _specs(run, titok_mod, vq_mod, gen_mod):
    f = base._fields(run)
    return (base._spec(titok_mod.TiTokSpec, f["titok"]),
            base._spec(vq_mod.MaskGITVQGANSpec, f["pixel"]),
            base._spec(gen_mod.UViTSpec, f["generator"]))


def reference_models(run):
    from ..reference import config as rc, maskgit_uvit as ru, maskgit_vqgan as rv, titok as rt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return base.build(run, rt.TiTok, ru.UViTGenerator, _specs(run, rc, rv, ru))


class Driver(base.Driver):
    def __init__(self, run):
        from sic_tpu_torch import config as pc
        from sic_tpu_torch.models import configure_numerics
        from sic_tpu_torch.models import maskgit as pm, maskgit_vqgan as pv, titok as pt
        from sic_tpu_torch.models import maskgit_uvit as pu
        from ._codec import Clock
        self.run = run
        self.sampling = run.config["sampling"]
        self.batch = int(run.traffic["batch"])
        clock = Clock()
        configure_numerics()
        self.titok, self.gen = base.build(run, pt.TiTok, pu.UViTGenerator,
                                          _specs(run, pc, pv, pu))
        self._generate = pm.generate
        self.classes = self.gen.spec.condition_num_classes
        self.rng = np.random.default_rng([run.seed, 3])
        self.calls = []
        self.gen.register_forward_pre_hook(lambda _m, a: self.calls.append(a[0]))
        self.kept = Reservoir(int(run.traffic["sample_batches"]),
                              np.random.default_rng([run.seed, 4]))
        clock.lap("models")
        self.step(record=False)      # warm the batch's shapes
        clock.lap("warm")

    def check(self) -> dict:
        self._ref = reference_models(self.run)
        return follow(self.run, *self._ref, self.outputs, self.sampling)

    def control_check(self) -> dict:
        return follow(self.run, *self._ref, self.outputs, self.sampling,
                      control=True)

    def counts(self):
        """One image of a batch: two generator passes at every step, then
        TiTok's token decode, on the reference's modules (meta device)."""
        from ..harness.counts import _dtype_name, count
        from ..reference import config as rc, maskgit_uvit as ru, maskgit_vqgan as rv, titok as rt
        ts, ps, gs = _specs(self.run, rc, rv, ru)
        with torch.device("meta"):
            titok = rt.TiTok(ts, ps).eval().requires_grad_(False)
            gen = ru.UViTGenerator(gs).eval().requires_grad_(False)
        ids = torch.zeros((1, gs.image_seq_len), dtype=torch.long, device="meta")
        cond = torch.zeros((1,), dtype=torch.long, device="meta")
        drop = torch.zeros((1,), dtype=torch.bool, device="meta")
        passes = 2 * int(self.sampling["num_sample_steps"])

        def work():
            with torch.no_grad():
                for _ in range(passes):
                    gen(ids, cond, drop)
                titok.decode_tokens(ids)

        flops, attn = count(work)
        return flops, attn, _dtype_name(self.run)


@torch.no_grad()
def follow(run, titok, gen, batches, sampling, control: bool = False):
    """``generate.follow`` with the configuration's guidance: at each step
    the widest gap of a chosen token below the reference's best noisy
    logit, and the widest pixel gap of the final tokens' decode; with
    ``control`` the reference in TF32 stands in for the program."""
    from ..reference.maskgit_uvit import _gumbel, guided_logits, step_schedule
    dev = run.device
    steps = int(sampling["num_sample_steps"])
    guide = {k: sampling[k] for k in ("guidance_scale", "guidance_decay",
                                      "softmax_temperature_annealing")}
    L = gen.spec.image_seq_len
    mask_id = gen.spec.mask_token_id
    token_gap, pixel_gap = 0.0, 0.0
    for labels, noise_seed, traj, tokens, pixels in batches:
        cond = torch.from_numpy(np.asarray(labels)).to(dev)
        g = torch.Generator(device=dev).manual_seed(noise_seed)
        states = [t.to(dev) for t in traj] + [tokens.to(dev)]
        for step in range(steps):
            temp, _ = step_schedule(step, steps, L, sampling["randomize_temperature"])
            temp = temp.to(dev)
            ids, nxt = states[step], states[step + 1]
            logits = guided_logits(gen, ids, cond, step, steps, **guide)
            noise = _gumbel(g, logits.shape).to(dev)
            _gumbel(g, logits.shape[:2])          # the confidence's draw
            noisy = logits + temp * noise
            newly = (ids == mask_id) & (nxt != mask_id)
            if not newly.any():
                continue
            # a position keeps the token it was unmasked with: judge the
            # final tokens there, so a token altered at the end shows too
            chosen = states[-1]
            if control:
                with base.tf32():
                    low = guided_logits(gen, ids, cond, step, steps, **guide)
                chosen = torch.argmax(low + temp * noise, dim=-1)
            best = noisy.max(dim=-1).values
            chosen = torch.where(newly, chosen, torch.zeros_like(chosen))
            got = torch.gather(noisy, -1, chosen[..., None])[..., 0]
            token_gap = max(token_gap, float((best - got)[newly].max()))
        ref_px = titok.decode_tokens(tokens.to(dev)).float().cpu()
        if control:
            with base.tf32():
                prog_px = titok.decode_tokens(tokens.to(dev)).float().cpu()
        else:
            prog_px = pixels.float()
        pixel_gap = max(pixel_gap, float((ref_px - prog_px).abs().max()))
    return {"token_gap": token_gap, "pixel_max_abs": pixel_gap}
