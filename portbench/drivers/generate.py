"""Class-conditional generation: a closed loop of batches of seeded class
labels through the port's MaskGIT sampler (``models.maskgit.generate``,
classifier-free guidance doubling the generator's rows) and
``TiTok.decode_tokens``, the pixels on the host.

Traffic keys: ``batch`` (labels a batch), ``sample_batches`` (batches of
the window the reference follows again), ``limits``.

The sampled batches are drawn from the seed as the window runs
(``harness.sample.Reservoir``), and only they are kept.  The check
follows each sampled batch's token trajectory: at every step the
reference's guided logits, plus the step's Gumbel noise drawn again from
the batch's generator seed, must put first the token the program chose
at each position it unmasked (``token_gap``: the widest gap by which a
chosen token lies below the reference's best), and the reference's pixels
of the final tokens must match the program's (``pixel_max_abs``)."""
from __future__ import annotations


import numpy as np
import torch
from torch.profiler import record_function

from ..harness.sample import Reservoir
from ..harness.weights import init_seeded

SEED_MOD = 1 << 63


def _fields(run):
    return run.config["rehearsal"] if run.tiny else run.config["spec"]


def _spec(cls, fields):
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})


def _specs(run, titok_mod, vq_mod, gen_mod):
    f = _fields(run)
    return (_spec(titok_mod.TiTokSpec, f["titok"]),
            _spec(vq_mod.MaskGITVQGANSpec, f["pixel"]),
            _spec(gen_mod.MaskGITSpec, f["generator"]))


def build(run, titok_cls, gen_cls, specs):
    """(TiTok, generator) on the run's device with the benchmark's
    seeded weights (TiTok from the seed, the generator from the next)."""
    ts, ps, gs = specs
    with torch.device(run.device):
        titok, gen = titok_cls(ts, ps), gen_cls(gs)
    init_seeded(titok, run.seed)
    init_seeded(gen, (run.seed + 1) % SEED_MOD)
    return (titok.eval().requires_grad_(False), gen.eval().requires_grad_(False))


def reference_models(run):
    from ..reference import config as rc, maskgit as rm, maskgit_vqgan as rv, titok as rt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return build(run, rt.TiTok, rm.MaskGITGenerator, _specs(run, rc, rv, rm))


class Driver:
    def __init__(self, run):
        from sic_tpu_torch import config as pc
        from sic_tpu_torch.models import configure_numerics
        from sic_tpu_torch.models import maskgit as pm, maskgit_vqgan as pv, titok as pt
        self.run = run
        self.sampling = run.config["sampling"]
        self.batch = int(run.traffic["batch"])
        from ._codec import Clock
        clock = Clock()
        configure_numerics()
        self.titok, self.gen = build(run, pt.TiTok, pm.MaskGITGenerator,
                                     _specs(run, pc, pv, pm))
        self._generate = pm.generate
        self.classes = self.gen.spec.condition_num_classes
        self.rng = np.random.default_rng([run.seed, 3])
        self.calls = []
        self.gen.register_forward_pre_hook(lambda _m, a: self.calls.append(a[0]))
        # (labels, noise seed, trajectory, tokens, pixels) of the sampled batches
        self.kept = Reservoir(int(run.traffic["sample_batches"]),
                              np.random.default_rng([run.seed, 4]))
        clock.lap("models")
        self.step(record=False)      # warm the batch's shapes
        clock.lap("warm")

    def step(self, record: bool = True) -> int:
        labels = self.rng.integers(0, self.classes, self.batch)
        noise_seed = int(self.rng.integers(0, SEED_MOD))
        dev = self.run.device
        cond = torch.from_numpy(labels).to(dev)
        g = torch.Generator(device=dev).manual_seed(noise_seed)
        self.calls = []
        with record_function("portbench.generate"):
            tokens = self._generate(self.gen, g, cond, **self.sampling)
        with record_function("portbench.decode_tokens"):
            pixels = self.titok.decode_tokens(tokens)
        pixels = pixels.cpu()
        slot = self.kept.wants() if record else None
        if slot is not None:
            traj = self.calls[::2] if self.sampling["guidance_scale"] else self.calls
            self.kept.keep(slot, (labels, noise_seed, traj, tokens, pixels))
        return self.batch

    def counters(self) -> dict:
        return {}

    def release(self) -> None:
        self.outputs = [(l, s, [t.cpu() for t in tr], tok.cpu(), px)
                        for l, s, tr, tok, px in self.kept.items()]
        del self.titok, self.gen
        import gc
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self) -> dict:
        self._ref = reference_models(self.run)
        return follow(self.run, *self._ref, self.outputs, self.sampling)

    def control_check(self) -> dict:
        """The control: the reference computed in TF32, in the program's
        place, along the same trajectories."""
        return follow(self.run, *self._ref, self.outputs, self.sampling,
                      control=True)

    def counts(self):
        from ..harness.counts import generate_counts
        return generate_counts(self.run, self.sampling)


@torch.no_grad()
def guided_logits(gen, ids, cond, scale):
    B = ids.shape[0]
    no = torch.zeros((B,), dtype=torch.bool, device=ids.device)
    logits = gen(ids, cond, no).float()
    if scale:
        uncond = gen(ids, cond, ~no).float()
        logits = logits + (logits - uncond) * scale
    return logits


class tf32:
    """TF32 on for matrix products and convolutions inside the block: the
    control's precision (the next below the configuration's fp32)."""

    def __init__(self, on: bool = True):
        self.on = on

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.prev


@torch.no_grad()
def follow(run, titok, gen, batches, sampling, control: bool = False):
    """The reference along each batch's trajectory: the widest gap of a
    chosen token below the reference's best noisy logit, and the widest
    pixel gap of the final tokens' decode.  With ``control`` the
    reference computed in TF32 stands in for the program: its own first
    token at each position the program unmasked, and its own decode."""
    from ..reference.maskgit import _gumbel, step_schedule
    dev = run.device
    steps = int(sampling["num_sample_steps"])
    scale = sampling["guidance_scale"]
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
            logits = guided_logits(gen, ids, cond, scale)
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
                with tf32():
                    low = guided_logits(gen, ids, cond, scale)
                chosen = torch.argmax(low + temp * noise, dim=-1)
            best = noisy.max(dim=-1).values
            chosen = torch.where(newly, chosen, torch.zeros_like(chosen))
            got = torch.gather(noisy, -1, chosen[..., None])[..., 0]
            token_gap = max(token_gap, float((best - got)[newly].max()))
        ref_px = titok.decode_tokens(tokens.to(dev)).float().cpu()
        if control:
            with tf32():
                prog_px = titok.decode_tokens(tokens.to(dev)).float().cpu()
        else:
            prog_px = pixels.float()
        pixel_gap = max(pixel_gap, float((ref_px - prog_px).abs().max()))
    return {"token_gap": token_gap, "pixel_max_abs": pixel_gap}
