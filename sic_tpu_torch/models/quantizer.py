"""Codebooks: the semantic stream's l2-normalized vector quantizer
(reference: src/titok/quantizer.py:30-95) and the VQGAN codebook
(reference: src/taming/modules/vqvae/quantize.py:213-330), with their
straight-through gradients and training losses."""
from __future__ import annotations

import torch
from torch import nn


def _l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), eps)


def nearest_code(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin_j ||z - c_j||^2 as the argmax of ``2 z.c_j - ||c_j||^2``, in
    fp32, the JAX package's formula, so near-ties break the same way."""
    z32 = z_flat.float()
    cb32 = codebook.float()
    scores = 2.0 * (z32 @ cb32.T) - torch.sum(cb32 * cb32, dim=-1)[None, :]
    return torch.argmax(scores, dim=-1)


class L2VectorQuantizer(nn.Module):
    def __init__(self, codebook_size: int = 4096, token_size: int = 12,
                 commitment_cost: float = 0.25, use_l2_norm: bool = True):
        super().__init__()
        self.commitment_cost = commitment_cost
        self.use_l2_norm = use_l2_norm
        self.embedding = nn.Parameter(torch.empty(codebook_size, token_size)
                                      .uniform_(-1.0 / codebook_size,
                                                1.0 / codebook_size))

    def codebook(self) -> torch.Tensor:
        return _l2n(self.embedding) if self.use_l2_norm else self.embedding

    def encode_indices(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, N, token_size) -> nearest code indices (B, N), in fp32
        whatever the input type (the inference path: no losses)."""
        B, N, C = z.shape
        z_flat = z.float().reshape(-1, C)
        if self.use_l2_norm:
            z_flat = _l2n(z_flat)
        return nearest_code(z_flat, self.codebook()).reshape(B, N)

    def forward(self, z: torch.Tensor):
        """The training forward: z (B, N, token_size) -> (z_q, result); z_q
        passes the gradient straight through to z, and ``result`` holds
        ``quantizer_loss``, ``commitment_loss``, ``codebook_loss`` and
        ``min_encoding_indices`` (B, N)."""
        idx = self.encode_indices(z)
        z_q = self.codebook()[idx]
        z32 = z.float()
        z_cmp = _l2n(z32) if self.use_l2_norm else z32
        commitment = self.commitment_cost * torch.mean((z_q.detach() - z_cmp) ** 2)
        codebook_loss = torch.mean((z_q - z_cmp.detach()) ** 2)
        z_q = z_cmp + (z_q - z_cmp).detach()
        return z_q.to(z.dtype), {
            "quantizer_loss": commitment + codebook_loss,
            "commitment_loss": commitment,
            "codebook_loss": codebook_loss,
            "min_encoding_indices": idx,
        }

    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """(..,) int -> (.., token_size), l2-normalized to match encode."""
        z_q = self.codebook()[indices.long()]
        return _l2n(z_q) if self.use_l2_norm else z_q


# the VQGAN codebook's commitment weight (taming's beta); the TiTok codebook
# takes its spec's commitment_cost
COMMITMENT_COST = 0.25


class VQGANQuantizer(nn.Module):
    def __init__(self, n_embed: int = 256, embed_dim: int = 256):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(n_embed, embed_dim)
                                      .uniform_(-1.0 / n_embed, 1.0 / n_embed))

    def codebook(self) -> torch.Tensor:
        return self.embedding

    def forward(self, z: torch.Tensor):
        """z: (B, H, W, C) -> (z_q, loss, {"indices": (B, H, W)}), the
        commitment-weighted loss and a straight-through z_q."""
        B, H, W, C = z.shape
        z32 = z.float()
        cb = self.codebook()
        idx = nearest_code(z32.reshape(-1, C), cb)
        z_q = cb[idx].reshape(B, H, W, C)
        loss = (torch.mean((z_q.detach() - z32) ** 2) * COMMITMENT_COST
                + torch.mean((z_q - z32.detach()) ** 2))
        z_q = z32 + (z_q - z32).detach()
        return z_q.to(z.dtype), loss, {"indices": idx.reshape(B, H, W)}
