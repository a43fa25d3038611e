"""Weights of the port: load a flat JAX-package parameter dict, or make a
seeded initialisation.

The JAX package stores params as a flax tree; flattened with ``/`` it is a
dict of ``params/<module path>/<leaf>`` numpy arrays (the committed
``tests/fixtures/golden/params.npz``).  The port's module names are chosen so
each torch parameter name maps onto one such key: ``name.<i>`` becomes
``name_<i>`` (flax's list and dict entries) and the leaf is renamed and
re-laid out by the kind of module that owns it:

- ``nn.Linear``: ``weight`` <- ``kernel`` (in, out), transposed;
- convolutions: ``weight`` <- ``kernel`` HWIO, permuted to OIHW;
- ``LayerNorm`` / ``GroupNorm``: ``weight`` <- ``scale``;
- every other parameter keeps its name and layout.

Persistent buffers (the discriminator's BatchNorm statistics) map onto the
flax ``batch_stats`` collection the same way: ``batch_stats/<path>/<leaf>``.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

# the VQGAN teacher encoder, which only training runs; the seeded
# initialisation draws it last (see init_seeded)
TEACHER = ("vqgan.encoder.", "vqgan.quant_conv.")


def flax_key(torch_name: str, module: nn.Module,
             collection: str = "params") -> str:
    """Flat JAX-package key of the torch parameter (or, with ``collection``
    ``"batch_stats"``, buffer) ``torch_name``, owned by ``module``."""
    path, leaf = torch_name.rsplit(".", 1) if "." in torch_name else ("", torch_name)
    path = re.sub(r"\.(\d+)(?=\.|$)", r"_\1", path).replace(".", "/")
    if leaf == "weight":
        leaf = "scale" if isinstance(module, (nn.LayerNorm, nn.GroupNorm)) \
            else "kernel"
    return f"{collection}/" + (f"{path}/{leaf}" if path else leaf)


def _to_torch_layout(value: np.ndarray, module: nn.Module, leaf: str) -> np.ndarray:
    if leaf == "weight" and isinstance(module, nn.Linear):
        return value.T
    if leaf == "weight" and isinstance(module, nn.Conv2d):
        return value.transpose(3, 2, 0, 1)
    return value


def _owners(model: nn.Module):
    """(torch name, owning module, leaf name, parameter) for every parameter."""
    for mod_name, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            yield name, mod, leaf, p


def named_flax_params(model: nn.Module):
    """(JAX-package key, parameter) for every parameter of ``model``."""
    for name, mod, _leaf, p in _owners(model):
        yield flax_key(name, mod), p


def _buffers(model: nn.Module):
    """(flax key, buffer) for every persistent buffer."""
    for mod_name, mod in model.named_modules():
        for leaf, b in mod.named_buffers(recurse=False):
            if leaf in mod._non_persistent_buffers_set:
                continue
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            yield flax_key(name, mod, "batch_stats"), b


def load_flax_params(model: nn.Module, flat: Mapping[str, np.ndarray]) -> set:
    """Copy a flat ``params/...`` dict into ``model``.  Every parameter must
    find its leaf; returns the set of leaves no parameter consumed."""
    unused = set(flat)
    with torch.no_grad():
        for name, mod, leaf, p in _owners(model):
            key = flax_key(name, mod)
            if key not in flat:
                raise KeyError(f"no leaf {key} for parameter {name}")
            value = _to_torch_layout(np.asarray(flat[key], np.float32), mod, leaf)
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{key}: shape {value.shape} does not fit "
                                 f"{name} {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.ascontiguousarray(value)))
            unused.discard(key)
        for key, b in _buffers(model):
            if key not in flat:
                raise KeyError(f"no leaf {key} for a buffer")
            b.copy_(torch.from_numpy(np.asarray(flat[key], np.float32)))
            unused.discard(key)
    return unused


def export_flax_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """Inverse of :func:`load_flax_params`: the model's parameters as a
    flat ``params/...`` dict in the JAX package's names and layouts, f32
    (a bf16-stored leaf is upcast, exactly: numpy has no bf16 on every
    machine; :func:`load_flax_params` copies it back into its storage
    dtype)."""
    flat = {}
    for name, mod, leaf, p in _owners(model):
        value = p.detach().float().cpu().numpy()
        if leaf == "weight" and isinstance(mod, nn.Linear):
            value = value.T
        elif leaf == "weight" and isinstance(mod, nn.Conv2d):
            value = value.transpose(2, 3, 1, 0)
        flat[flax_key(name, mod)] = np.array(value, order="C")   # a copy
    for key, b in _buffers(model):
        flat[key] = b.detach().cpu().numpy().copy()
    return flat


def load_npz(model: nn.Module, path) -> set:
    with np.load(path) as z:
        return load_flax_params(model, {k: z[k] for k in z.files})


def init_seeded(model: nn.Module, seed: int = 0) -> None:
    """Seeded initialisation of every parameter, drawn on the model's
    device from one explicit generator (the flax initializers' scales:
    lecun-normal matrices, zero biases, unit norms, N(0, 1) position
    biases, width**-0.5 embeddings, +-1/K codebooks, N(0, 0.02) token
    embeddings and the leaves a module names in ``normal_002``).  The VQGAN teacher
    encoder draws after every other parameter, so the rest of a codec gets
    the weights it had before the teacher was part of it."""
    g = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    owners = sorted(_owners(model), key=lambda o: o[0].startswith(TEACHER))
    with torch.no_grad():
        for name, mod, leaf, p in owners:
            if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                p.zero_()
            elif leaf == "weight":            # Linear / Conv2d
                fan_in = p[0].numel()
                p.normal_(0.0, fan_in ** -0.5, generator=g)
            elif name.endswith("token_embedding.embedding") \
                    or leaf in getattr(mod, "normal_002", ()):   # CLIP text, MaskGIT
                p.normal_(0.0, 0.02, generator=g)
            elif leaf == "embedding":         # codebooks
                k = p.shape[0]
                p.uniform_(-1.0 / k, 1.0 / k, generator=g)
            elif leaf == "pos_embedding":
                p.normal_(0.0, 1.0, generator=g)
            elif leaf in ("titok_pos_emb", "feat_pos_emb"):
                p.zero_()
            elif leaf in ("layer_scale", "enc_q", "dec_q",
                          "factorized_prior_vec"):
                p.fill_(1.0)
            else:                             # token / position embeddings
                p.normal_(0.0, p.shape[-1] ** -0.5, generator=g)
            if name.endswith("zero_add.weight"):
                p.zero_()
