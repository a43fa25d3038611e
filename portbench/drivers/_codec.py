"""What the codec cells share: the configuration's spec for the program
and for the reference, the program's runtime on seeded weights, the
reference codec, and the comparison of pixels."""
from __future__ import annotations

import numpy as np
import torch

from ..harness.weights import init_seeded


class Clock:
    """Set-up phases on the host's clock, printed to standard error."""

    def __init__(self):
        import time
        self._now = time.perf_counter
        self.t = self._now()

    def lap(self, what: str) -> None:
        import sys
        t = self._now()
        print(f"setup {what}: {t - self.t:.3f} s", file=sys.stderr, flush=True)
        self.t = t


def spec_fields(run) -> dict:
    """The configuration's spec fields (the rehearsal's tiny ones with
    ``--cpu-tiny``)."""
    return run.config["rehearsal"] if run.tiny else run.config["spec"]


def _build_spec(mod, fields: dict):
    f = dict(fields)
    titok = mod.TiTokSpec(**f.pop("titok"))
    vq = dict(f.pop("vqgan"))
    for k in ("ch_mult", "attn_resolutions"):
        vq[k] = tuple(vq[k])
    for k in ("insert_pos_enc", "insert_pos_dec"):
        f[k] = tuple(f[k])
    return mod.CodecSpec(titok=titok, vqgan=mod.VQGANSpec(**vq), **f)


def program_spec(run):
    from sic_tpu_torch import config
    return _build_spec(config, spec_fields(run))


def reference_spec(run):
    from ..reference import config
    return _build_spec(config, spec_fields(run))


def compute_dtype(run):
    return torch.float32 if run.tiny else getattr(torch, run.config["compute_dtype"])


def program_runtime(run, quant=None):
    """The program's ``CodecRuntime`` as ``load_runtime`` builds it, with
    the benchmark's seeded weights in place of the program's own."""
    from sic_tpu_torch.models import Codec, CodecRuntime
    spec = program_spec(run)
    with torch.device(run.device):
        model = Codec(spec)
    init_seeded(model, run.seed)
    model.eval().requires_grad_(False)
    return CodecRuntime(spec, model, stream_part=int(run.config["stream_part"]),
                        z_format="rans", dtype=compute_dtype(run), quant=quant)


def reference_numerics() -> None:
    """fp32 with TF32 off, deterministic convolutions: the numerics the
    port's coding chain fixes (a decode replays the encoder's floats)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def reference_codec(run):
    from ..reference.codec import Codec
    reference_numerics()
    with torch.device(run.device):
        model = Codec(reference_spec(run))
    init_seeded(model, run.seed)
    return model.eval().requires_grad_(False)


def free_cuda() -> None:
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def tail_ratio(prog, ref16, ref, over: int) -> float:
    """How far the program's values stray from the fp32 reference's,
    against how far plain bf16 arithmetic (the configuration's precision)
    strays on the same inputs: (values of the program more than ``over``
    off, + 1) / (values of the bf16 reference as far off, + 1).  Rounding
    to bf16 reads about 1, whatever the seed's weights make of the
    values' sensitivity; a coarser path, or a wrong answer, reads far more."""
    ref = np.asarray(ref).astype(np.int64)
    n_prog = int((np.abs(np.asarray(prog).astype(np.int64) - ref) > over).sum())
    n_ref16 = int((np.abs(np.asarray(ref16).astype(np.int64) - ref) > over).sum())
    return (n_prog + 1) / (n_ref16 + 1)
