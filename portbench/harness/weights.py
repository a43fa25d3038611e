"""Seeded weights, drawn on the model's device from one generator.

The scales are the flax initializers' (a copy of the port's
``init_seeded`` arithmetic): lecun-normal matrices, zero biases, unit
norms, N(0, 1) position biases, width**-0.5 embeddings, +-1/K codebooks,
N(0, 0.02) token embeddings and the leaves a module names in
``normal_002``; the VQGAN teacher encoder draws last.  The benchmark
draws them itself, into the program's model and, after the window, into
the reference's, which has the same parameter names in the same order."""
from __future__ import annotations

import torch
from torch import nn

TEACHER = ("vqgan.encoder.", "vqgan.quant_conv.")


def owners(model: nn.Module):
    """(name, owning module, leaf, parameter) for every parameter."""
    for mod_name, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            yield (f"{mod_name}.{leaf}" if mod_name else leaf), mod, leaf, p


@torch.no_grad()
def init_seeded(model: nn.Module, seed: int) -> None:
    g = torch.Generator(device=next(model.parameters()).device)
    g.manual_seed(int(seed))
    ordered = sorted(owners(model), key=lambda o: o[0].startswith(TEACHER))
    for name, mod, leaf, p in ordered:
        if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias":
            p.zero_()
        elif leaf == "weight":                        # Linear / Conv2d
            p.normal_(0.0, p[0].numel() ** -0.5, generator=g)
        elif name.endswith("token_embedding.embedding") \
                or leaf in getattr(mod, "normal_002", ()):
            p.normal_(0.0, 0.02, generator=g)
        elif leaf == "embedding":                     # codebooks
            k = p.shape[0]
            p.uniform_(-1.0 / k, 1.0 / k, generator=g)
        elif leaf == "pos_embedding":
            p.normal_(0.0, 1.0, generator=g)
        elif leaf in ("titok_pos_emb", "feat_pos_emb"):
            p.zero_()
        elif leaf in ("layer_scale", "enc_q", "dec_q", "factorized_prior_vec"):
            p.fill_(1.0)
        else:                                         # token / position embeddings
            p.normal_(0.0, p.shape[-1] ** -0.5, generator=g)
        if name.endswith("zero_add.weight"):
            p.zero_()
