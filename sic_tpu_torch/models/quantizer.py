"""Codebooks of the decode path: the semantic stream's l2-normalized
codebook (reference: src/titok/quantizer.py:30-95) and the VQGAN codebook
(reference: src/taming/modules/vqvae/quantize.py:213-330).  The encode-side
nearest-code search is not ported yet."""
from __future__ import annotations

import torch
from torch import nn


def _l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), eps)


class L2VectorQuantizer(nn.Module):
    def __init__(self, codebook_size: int = 4096, token_size: int = 12,
                 use_l2_norm: bool = True):
        super().__init__()
        self.use_l2_norm = use_l2_norm
        self.embedding = nn.Parameter(torch.empty(codebook_size, token_size)
                                      .uniform_(-1.0 / codebook_size,
                                                1.0 / codebook_size))

    def codebook(self) -> torch.Tensor:
        return _l2n(self.embedding) if self.use_l2_norm else self.embedding

    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """(..,) int -> (.., token_size), l2-normalized to match encode."""
        z_q = self.codebook()[indices.long()]
        return _l2n(z_q) if self.use_l2_norm else z_q


class VQGANQuantizer(nn.Module):
    def __init__(self, n_embed: int = 256, embed_dim: int = 256):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(n_embed, embed_dim)
                                      .uniform_(-1.0 / n_embed, 1.0 / n_embed))

    def codebook(self) -> torch.Tensor:
        return self.embedding
