"""Attention modules of the dual-hand mesh decoder (port of
``pdfnet_tpu/models/attention.py``; reference self_attn.py:36-86,
inter_attn.py:38-125 and img_attn.py:38-113).

Token counts are tiny (<= 252 vertices + 36 grid tokens), so attention is a
plain matmul + softmax, like the JAX einsums.  Dropout (on the attention
weights and on the projected output, ``attention.py:51,54,104-105``) acts at
train time only.  ``ImgAttn`` runs only under ``Config.use_img_attn``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pdfnet_tpu_torch.models.layers import Dropout, LN_EPS, MLPResBlock


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, V, D = x.shape
    return x.reshape(B, V, n_heads, D // n_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, V, D = x.shape
    return x.transpose(1, 2).reshape(B, V, H * D)


def _attend(q, k, v, d_q: int, drop: Dropout) -> torch.Tensor:
    a = drop(torch.softmax(q @ k.transpose(-1, -2) / (d_q ** 0.5), dim=-1))
    return _merge_heads(a @ v)


class SelfAttn(nn.Module):
    def __init__(self, f_dim: int, n_heads: int = 4, dropout: float = 0.1):
        super().__init__()
        self.n_heads = n_heads
        self.d_q = f_dim // n_heads
        self.ln = nn.LayerNorm(f_dim, eps=LN_EPS)
        self.wq = nn.Linear(f_dim, n_heads * self.d_q)
        self.wk = nn.Linear(f_dim, n_heads * self.d_q)
        self.wv = nn.Linear(f_dim, n_heads * self.d_q)
        self.fc = nn.Linear(n_heads * self.d_q, f_dim)
        self.ff = MLPResBlock(f_dim, f_dim, dropout)
        self.drop_attn = Dropout(dropout)
        self.drop_out = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ln(x)
        q, k, v = (_split_heads(w(h), self.n_heads)
                   for w in (self.wq, self.wk, self.wv))
        out = self.fc(_attend(q, k, v, self.d_q, self.drop_attn))
        return self.ff(x + self.drop_out(out))


class InterAttn(nn.Module):
    """Self-attention per hand, then bidirectional cross-hand attention with
    q/k/v/out projections shared between the two directions."""

    def __init__(self, f_dim: int, n_heads: int = 4, dropout: float = 0.1):
        super().__init__()
        self.n_heads = n_heads
        self.d_q = f_dim // n_heads
        self.self_L = SelfAttn(f_dim, n_heads, dropout)
        self.self_R = SelfAttn(f_dim, n_heads, dropout)
        self.wq = nn.Linear(f_dim, n_heads * self.d_q)
        self.wk = nn.Linear(f_dim, n_heads * self.d_q)
        self.wv = nn.Linear(f_dim, n_heads * self.d_q)
        self.fc = nn.Linear(n_heads * self.d_q, f_dim)
        self.ln_L = nn.LayerNorm(f_dim, eps=LN_EPS)
        self.ln_R = nn.LayerNorm(f_dim, eps=LN_EPS)
        self.ffL = MLPResBlock(f_dim, f_dim, dropout)
        self.ffR = MLPResBlock(f_dim, f_dim, dropout)
        # one module each, drawing anew per use, as flax shares them
        self.drop_attn = Dropout(dropout)
        self.drop_out = Dropout(dropout)

    def _cross(self, q, k, v):
        return self.drop_out(self.fc(_attend(q, k, v, self.d_q,
                                             self.drop_attn)))

    def forward(self, Lf: torch.Tensor, Rf: torch.Tensor):
        Lf, Rf = self.self_L(Lf), self.self_R(Rf)
        L2, R2 = self.ln_L(Lf), self.ln_R(Rf)
        Lq, Lk, Lv = (_split_heads(w(L2), self.n_heads)
                      for w in (self.wq, self.wk, self.wv))
        Rq, Rk, Rv = (_split_heads(w(R2), self.n_heads)
                      for w in (self.wq, self.wk, self.wv))
        # L queries attend R keys/values: feat_R2L flows into the left hand
        feat_R2L = self._cross(Lq, Rk, Rv)
        feat_L2R = self._cross(Rq, Lk, Lv)
        return self.ffL(Lf + feat_R2L), self.ffR(Rf + feat_L2R)


class ImgAttn(nn.Module):
    """Patchify an image feature map into grid tokens, which the vertices
    attend (``attention.py:137-166``): a strided conv, ReLU, the raw
    ``pos_emb`` parameter, self-attention over the grid, a Linear to the
    vertex width, then self-attention over vertices + grid; returns the
    vertex tokens."""

    def __init__(self, img_size: int, img_f_dim: int, grid_size: int,
                 grid_f_dim: int, verts_f_dim: int, n_heads: int = 4,
                 dropout: float = 0.01):
        super().__init__()
        patch = img_size // grid_size
        self.proj = nn.Conv2d(img_f_dim, grid_f_dim, patch, stride=patch)
        self.pos_emb = nn.Parameter(torch.zeros(grid_size * grid_size,
                                                grid_f_dim))
        self.grid_attn = SelfAttn(grid_f_dim, n_heads, dropout)
        self.fc = nn.Linear(grid_f_dim, verts_f_dim)
        self.joint_attn = SelfAttn(verts_f_dim, n_heads, dropout)

    def forward(self, img: torch.Tensor, verts_f: torch.Tensor) -> torch.Tensor:
        """img (B, img_f_dim, img_size, img_size), verts_f (B, V, D)."""
        grid = F.relu(self.proj(img)).flatten(2).transpose(1, 2)  # (B, G, C)
        grid = self.fc(self.grid_attn(grid + self.pos_emb[None]))
        V = verts_f.shape[1]
        return self.joint_attn(torch.cat([verts_f, grid], dim=1))[:, :V]
