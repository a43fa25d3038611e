"""The CLIP text side of the port against the JAX package, on the CPU.

The masked MHSA branch, the text tower and the two-tower codec take the
same weights in both packages (the port's parameters exported to the JAX
package's flat names) and the same token ids: 1e-4 (fp32; the two
frameworks sum in other orders).  The tokenizer's ids equal the JAX
package's exactly, for a merges file and for the hashed fallback; the
fallback hashes with Python's per-process salted ``hash()``, so every
comparison runs inside this one process.
"""
import gzip

import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

import jax.numpy as jnp

from sic_tpu_torch.weights import export_flax_params

TOL = 1e-4


def _randomize(module, seed):
    """Seeded weights with every leaf non-zero (LayerNorm scales near 1)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            fan_in = p[0].numel() if p.dim() > 1 else p.numel()
            scale = 0.02 if p.dim() == 1 else fan_in ** -0.5
            base = 1.0 if ".ln_" in f".{name}" and name.endswith("weight") else 0.0
            p.copy_(torch.from_numpy(
                base + scale * rng.standard_normal(p.shape).astype(np.float32)))
    return module.eval()


def _flax_vars(module):
    return {"params": unflatten_dict(export_flax_params(module), sep="/")["params"]}


def _close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


def _spec(jax_pkg: bool, **kw):
    mod = __import__("sic_tpu.retrieval.clip_model" if jax_pkg else
                     "sic_tpu_torch.retrieval.clip_model", fromlist=["CLIPSpec"])
    base = dict(vision_width=64, vision_layers=1, vision_heads=1, embed_dim=32,
                text_width=64, text_layers=2, text_heads=2, context_length=12,
                vocab_size=100)
    base.update(kw)
    return mod.CLIPSpec(**base)


def _tokens(B, n, vocab, seed):
    """Start id, random ids, the end id (the row's largest), zeros."""
    rng = np.random.default_rng(seed)
    tok = np.zeros((B, n), np.int32)
    for i in range(B):
        m = int(rng.integers(1, n - 1))
        tok[i, 0] = vocab - 2
        tok[i, 1:m] = rng.integers(1, vocab - 2, m - 1)
        tok[i, m] = vocab - 1
    return tok


def test_masked_multihead_self_attention():
    """The additive-mask branch (causal -inf mask, S 12) of the port's MHSA
    against flax's, through a whole pre-LN block."""
    from sic_tpu.models.layers import ResidualAttentionBlock as JBlock
    from sic_tpu_torch.models.layers import ResidualAttentionBlock
    m = _randomize(ResidualAttentionBlock(64, 2), 1)
    x = np.random.default_rng(2).standard_normal((3, 12, 64)).astype(np.float32)
    mask = np.triu(np.full((12, 12), -np.inf, np.float32), k=1)
    ref = JBlock(2).apply(_flax_vars(m), jnp.asarray(x), jnp.asarray(mask))
    _close(m(torch.from_numpy(x), torch.from_numpy(mask)), ref)


def test_text_tower_matches_flax():
    from sic_tpu.retrieval.clip_model import CLIPTextTower as JTower
    from sic_tpu_torch.retrieval import CLIPTextTower
    tower = _randomize(CLIPTextTower(_spec(False)), 3)
    tok = _tokens(4, 12, 100, 4)
    ref = JTower(_spec(True)).apply(_flax_vars(tower), jnp.asarray(tok))
    _close(tower(torch.from_numpy(tok)), ref)


def test_every_text_leaf_lands_in_one_parameter():
    """The bridge: the flax text tower's parameter tree and the port's
    exported names are the same set of leaves with the same shapes."""
    import jax
    from flax.traverse_util import flatten_dict

    from sic_tpu.retrieval.clip_model import CLIPModel as JModel
    from sic_tpu_torch.retrieval import CLIPModel
    from sic_tpu_torch.weights import load_flax_params
    jvars = JModel(_spec(True)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
        jnp.zeros((1, 12), jnp.int32))
    flat = {"params/" + "/".join(k): np.asarray(v)
            for k, v in flatten_dict(jvars["params"]).items()}
    model = CLIPModel(_spec(False))
    assert load_flax_params(model, flat) == set()
    ours = export_flax_params(model)
    assert sorted(ours) == sorted(flat)
    assert any(k.startswith("params/text/") for k in flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(ours[k], v)


def test_codec_text_vectors_match_jax():
    """ClipCodec.text_to_unit_vec (fallback tokenizer, context length 77,
    the full vocabulary) against the JAX ClipCodec under the same params."""
    from sic_tpu.retrieval import ClipCodec as JClip
    from sic_tpu_torch.retrieval import ClipCodec
    kw = dict(context_length=77, vocab_size=49408)
    clip = ClipCodec(spec=_spec(False, **kw), device="cpu", seed=5)
    _randomize(clip.model.text, 6)
    params = unflatten_dict(export_flax_params(clip.model), sep="/")
    jclip = JClip(params=params, spec=_spec(True, **kw))
    texts = ["a photo of an apple", "Two dogs &amp; a cat, 3 birds!"]
    np.testing.assert_array_equal(clip.tokenizer(texts), jclip.tokenizer(texts))
    got = clip.text_to_unit_vec(texts)
    assert got.shape == (2, 32)
    _close(got, jclip.text_to_unit_vec(texts))
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def _merges_file(path):
    """A tiny BPE merges .gz in the standard layout: a version line, then
    merges of the byte-level symbols."""
    merges = ["h e", "l l", "he ll", "o</w>", "hell o</w>", "a p", "p l",
              "ap pl", "e</w>", "appl e</w>", "c a", "ca t</w>"]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return str(path)


@pytest.mark.parametrize("bpe", [True, False], ids=["merges", "fallback"])
def test_tokenizer_ids_match_jax(tmp_path, bpe):
    from sic_tpu.retrieval.clip_model import SimpleTokenizer as JTok
    from sic_tpu_torch.retrieval import SimpleTokenizer
    path = _merges_file(tmp_path / "merges.txt.gz") if bpe else None
    texts = ["Hello apple", "a cat's hello!!", "  hello   world 42 ",
             "café &amp; apples", "x" * 200]
    ours, ref = SimpleTokenizer(path), JTok(path)
    assert ours.fallback == (not bpe)
    for t in texts:
        assert ours.encode_ids(t) == ref.encode_ids(t)
    np.testing.assert_array_equal(ours(texts), ref(texts))
    assert ours(texts).shape == (5, 77)


def test_open_clip_text_loader(tmp_path):
    """A fake open_clip state dict loads into the port's text tower the
    weights the JAX package's loader gives its own."""
    from sic_tpu.retrieval.clip_model import CLIPModel as JModel
    from sic_tpu.retrieval.clip_model import port_open_clip_weights as jport
    from sic_tpu_torch.retrieval import CLIPModel, port_open_clip_weights
    rng = np.random.default_rng(7)
    w, tw, e = 64, 64, 32

    def t(*shape):
        return torch.from_numpy(0.05 * rng.standard_normal(shape).astype(np.float32))

    def block(prefix, d):
        return {f"{prefix}.ln_1.weight": 1 + t(d), f"{prefix}.ln_1.bias": t(d),
                f"{prefix}.ln_2.weight": 1 + t(d), f"{prefix}.ln_2.bias": t(d),
                f"{prefix}.attn.in_proj_weight": t(3 * d, d),
                f"{prefix}.attn.in_proj_bias": t(3 * d),
                f"{prefix}.attn.out_proj.weight": t(d, d),
                f"{prefix}.attn.out_proj.bias": t(d),
                f"{prefix}.mlp.c_fc.weight": t(4 * d, d),
                f"{prefix}.mlp.c_fc.bias": t(4 * d),
                f"{prefix}.mlp.c_proj.weight": t(d, 4 * d),
                f"{prefix}.mlp.c_proj.bias": t(d)}

    sd = {"visual.conv1.weight": t(w, 3, 32, 32),
          "visual.class_embedding": t(w), "visual.positional_embedding": t(50, w),
          "visual.ln_pre.weight": 1 + t(w), "visual.ln_pre.bias": t(w),
          "visual.ln_post.weight": 1 + t(w), "visual.ln_post.bias": t(w),
          "visual.proj": t(w, e),
          "token_embedding.weight": t(100, tw), "positional_embedding": t(12, tw),
          "ln_final.weight": 1 + t(tw), "ln_final.bias": t(tw),
          "text_projection": t(tw, e)}
    sd.update(block("visual.transformer.resblocks.0", w))
    for i in range(2):
        sd.update(block(f"transformer.resblocks.{i}", tw))
    path = tmp_path / "open_clip.pt"
    torch.save(sd, path)

    model = CLIPModel(_spec(False))
    model.load_state_dict(port_open_clip_weights(path, _spec(False)))
    tok = _tokens(2, 12, 100, 8)
    ref = JModel(_spec(True)).apply(jport(str(path), _spec(True)),
                                    jnp.asarray(tok), method="encode_text")
    _close(model.eval().encode_text(torch.from_numpy(tok)), ref)
