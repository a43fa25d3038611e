"""The port's (G, s, d) window-attention op against the JAX package, on the
CPU.

On the CPU :func:`sic_tpu_torch.ops.window_attention` runs its plain version
under autograd; these tests hold it to the JAX package's
``_forward_reference`` and to its Pallas kernel in interpret mode (1e-5,
fp32, summation order only), and its gradients to ``jax.grad`` through the
JAX package's custom VJP (1e-4 of each gradient's largest magnitude).  The
CUDA kernel is held to the plain version by ``test_torch_gpu.py`` and
``chip_smoke.py`` on a card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sic_tpu_torch import ops

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _inputs(G, nW, s=32, d=64, seed=0, masked=True):
    """Unit-normal q, k, v and bias; with ``masked``, the last window's
    first quarter of query rows sees -inf over its second half of keys (a
    shifted layer's mask), so whole key tiles of those rows are -inf."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((G, s, d)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((nW, s, s)).astype(np.float32)
    if masked:
        bias[-1, : s // 4, s // 2:] = -np.inf
    return q, k, v, bias


@pytest.mark.parametrize("nW", [1, 2, 4])
def test_plain_matches_jax_reference_and_pallas_interpret(nW):
    from sic_tpu.ops.window_attention import _forward_reference, _pallas_forward
    q, k, v, bias = _inputs(8, nW, seed=nW)
    scale = 64 ** -0.5
    out = ops.window_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)),
                               scale).numpy()
    assert np.isfinite(out).all()
    jargs = [jnp.asarray(a) for a in (q, k, v, bias)]
    ref = np.asarray(_forward_reference(*jargs, scale))
    pallas = np.asarray(_pallas_forward(*jargs, scale, interpret=True))
    np.testing.assert_allclose(out, ref, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(out, pallas, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(
        ops.window_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, bias)),
                                   scale).numpy(), out, rtol=0, atol=0)


@pytest.mark.parametrize("nW", [1, 2, 4])
def test_gradients_match_jax_custom_vjp(nW):
    """Autograd of sum(sin(out)) for q, k, v and bias against jax.grad
    through the JAX package's custom-VJP window_attention (its _bwd)."""
    from sic_tpu.ops.window_attention import window_attention as jwa
    q, k, v, bias = _inputs(8, nW, seed=10 + nW)
    scale = 64 ** -0.5
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, bias)]
    torch.sin(ops.window_attention(*ts, scale)).sum().backward()
    ref = jax.grad(lambda *a: jnp.sum(jnp.sin(jwa(*a, scale))),
                   argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, bias)))
    for name, t, r in zip("qkvb", ts, ref):
        r = np.asarray(r)
        err = np.abs(t.grad.numpy() - r).max() / np.abs(r).max()
        assert err <= GRAD_TOL, f"d{name}: {err}"


def test_bwd_plain_matches_autograd():
    """The backward the CUDA autograd Function runs (the JAX package's
    _bwd in torch) equals autograd through the plain forward."""
    q, k, v, bias = _inputs(8, 2, seed=3)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, bias)]
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(q.shape)
                         .astype(np.float32))
    out = ops.window_attention_plain(*ts, 0.125)
    auto = torch.autograd.grad(out, ts, g)
    mine = ops.window_attention_bwd_plain(*(t.detach() for t in ts), g, 0.125)
    for a, b in zip(mine, auto):
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err <= GRAD_TOL, err


def test_refuses_what_it_cannot_take():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(6, 4, masked=False))
    with pytest.raises(ValueError, match="multiple"):
        ops.window_attention(q, k, v, bias, 0.125)      # G 6, nW 4
    q, k, v, bias = (torch.from_numpy(a).to("meta")
                     for a in _inputs(8, 2, masked=False))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.window_attention(q, k, v, bias, 0.125)


def test_cpu_path_launches_nothing():
    before = ops.launch_counts()["window_attention"]
    ops.window_attention(*(torch.from_numpy(a) for a in _inputs(4, 2)), 0.125)
    assert ops.launch_counts()["window_attention"] == before
