"""Global patch-fusion transformer (pre-norm ViT blocks).

The port's counterpart of ``omnifusion_tpu/models/transformer.py``:
separate q and kv projections without bias, a biased output projection,
exact (erf) GELU, LayerNorm eps 1e-5 in the blocks and 1e-6 at the end, a
learned positional embedding over the patch tokens, softmax in f32.
The blocks run in f32 whatever the tokens' dtype: the JAX package passes
the transformer no ``dtype``, so flax promotes bf16 tokens against the f32
parameters of the first LayerNorm, and the residual sum with it.
The sequence is tiny (at most 46 tokens), so attention is a plain
matmul + softmax.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim, bias=False, device=device)
        self.kv = nn.Linear(dim, 2 * dim, bias=False, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x):
        b, n, c = x.shape
        h = self.num_heads
        d = c // h
        q = self.q(x).reshape(b, n, h, d).transpose(1, 2)  # (b, h, n, d)
        kv = self.kv(x).reshape(b, n, 2, h, d)
        k = kv[:, :, 0].transpose(1, 2)
        v = kv[:, :, 1].transpose(1, 2)
        attn = (q @ k.transpose(-2, -1)) * (d**-0.5)
        attn = torch.softmax(attn, -1, dtype=torch.promote_types(attn.dtype, torch.float32))
        attn = attn.to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.attn = Attention(dim, num_heads, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class TransformerCascade(nn.Module):
    def __init__(self, dim: int, num_patches: int, depth: int = 6, num_heads: int = 4, device=None):
        super().__init__()
        self.pos_emb = nn.Parameter(torch.zeros(1, num_patches, dim, device=device))
        self.layer = nn.ModuleList(
            TransformerBlock(dim, num_heads, device=device) for _ in range(depth)
        )
        self.encoder_norm = nn.LayerNorm(dim, eps=1e-6, device=device)

    def forward(self, x):
        # bf16 tokens stay bf16 through the embedding's add
        # (omnifusion_tpu/models/transformer.py:92); flax's LayerNorm and
        # Dense then promote them against their f32 parameters, and the
        # residual sum with them, so the blocks and the output are f32
        x = x + self.pos_emb.to(x.dtype)
        x = x.to(torch.promote_types(x.dtype, self.pos_emb.dtype))
        for block in self.layer:
            x = block(x)
        return self.encoder_norm(x)
