"""Dual-hand Chebyshev-GCN mesh decoder (port of
``pdfnet_tpu/models/gcn_decoder.py``; reference intaghand_decoder.py:75-242,
model_attn/gcn.py, model_attn/DualGraph.py).

Runs in float32 (the JAX decoder's dtype) whatever the encoder's compute
dtype.  The JAX ``stacked_decoder`` eval form only regroups the same math
over a stacked hand axis; here the two hands simply run one after the other,
as the JAX modules do at train time.  Dropout (``Config.dropout``) acts at
train time only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pdfnet_tpu_torch import assets
from pdfnet_tpu_torch.models.attention import ImgAttn, InterAttn
from pdfnet_tpu_torch.models.layers import Dropout, LN_EPS
from pdfnet_tpu_torch.ops.chebconv import cheb_basis
from pdfnet_tpu_torch.ops.geometry import orthographic_project
from pdfnet_tpu_torch.ops.resize import upsample2x_nearest

V_ALL = 1008          # padded coarsening order


def graph_avg_pool(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, V, F) -> (B, V/p, F) contiguous-group average pooling."""
    if p <= 1:
        return x
    B, V, F_ = x.shape
    return x.reshape(B, V // p, p, F_).mean(dim=2)


class GCNResBlock(nn.Module):
    """cheb(x) -> fc1 -> relu(LN) -> cheb -> fc2 -> dropout, plus a Linear
    shortcut, -> LN (the live reference dataflow, gcn.py:100-108)."""

    def __init__(self, in_dim: int, out_dim: int, graph_k: int = 2,
                 dropout: float = 0.05):
        super().__init__()
        self.graph_k = graph_k
        self.fc1 = nn.Linear(in_dim * graph_k, out_dim)
        self.norm2 = nn.LayerNorm(out_dim, eps=LN_EPS)
        self.fc2 = nn.Linear(out_dim * graph_k, out_dim)
        self.shortcut = nn.Linear(in_dim, out_dim)
        self.norm3 = nn.LayerNorm(out_dim, eps=LN_EPS)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
        y = self.fc1(cheb_basis(x, L, self.graph_k))
        y = F.relu(self.norm2(y))
        y = self.drop(self.fc2(cheb_basis(y, L, self.graph_k)))
        return self.norm3(y + self.shortcut(x))


class GraphLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, graph_L: np.ndarray,
                 graph_k: int = 2, num_blocks: int = 4, dropout: float = 0.05):
        super().__init__()
        self.num_blocks = num_blocks
        self.register_buffer("L", torch.as_tensor(graph_L, dtype=torch.float32),
                             persistent=False)
        for i in range(num_blocks):
            self.add_module(f"block{i}", GCNResBlock(
                in_dim if i == 0 else out_dim, out_dim, graph_k, dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x, self.L)
            if i != self.num_blocks - 1:
                x = F.relu(x)
        return x


class DualGraphLayer(nn.Module):
    """One pyramid level: pos-emb -> per-hand GCN -> (with ``img_attn``,
    a tuple (img_size, img_f_dim, grid_size, grid_f_dim): each hand's image
    attention) -> cross-hand attention."""

    def __init__(self, in_dim: int, out_dim: int, graph_L_left: np.ndarray,
                 graph_L_right: np.ndarray, graph_k: int = 2,
                 num_blocks: int = 4, n_heads: int = 4,
                 dropout: float = 0.05,
                 img_attn: Optional[Tuple[int, int, int, int]] = None):
        super().__init__()
        V = graph_L_left.shape[0]
        self.pos_emb = nn.Embedding(V, in_dim)
        self.graph_left = GraphLayer(in_dim, out_dim, graph_L_left, graph_k,
                                     num_blocks, dropout)
        self.graph_right = GraphLayer(in_dim, out_dim, graph_L_right, graph_k,
                                      num_blocks, dropout)
        self.use_img_attn = img_attn is not None
        if self.use_img_attn:
            for side in ("left", "right"):
                self.add_module(f"img_ex_{side}", ImgAttn(
                    *img_attn, out_dim, n_heads, dropout))
        self.inter_attn = InterAttn(out_dim, n_heads, dropout)

    def forward(self, Lf: torch.Tensor, Rf: torch.Tensor,
                img_f: Optional[torch.Tensor] = None):
        pos = self.pos_emb.weight[None]
        Lf = self.graph_left(Lf + pos)
        Rf = self.graph_right(Rf + pos)
        if self.use_img_attn:
            Lf = self.img_ex_left(img_f, Lf)
            Rf = self.img_ex_right(img_f, Rf)
        return self.inter_attn(Lf, Rf)


class MeshDecoder(nn.Module):
    """Global hand features (+ with ``use_img_attn`` the image pyramid) ->
    dual 778-vertex meshes, weak-perspective params and a 3-vector
    absolute-root code per hand."""

    def __init__(self, global_feature_dim: int = 1024,
                 gcn_in_dim: Sequence[int] = (512, 256, 128),
                 gcn_out_dim: Sequence[int] = (256, 128, 64),
                 graph_k: int = 2, num_blocks: int = 4, n_heads: int = 4,
                 dropout: float = 0.05, img_size_px: int = 384,
                 use_img_attn: bool = False,
                 img_f_dims: Sequence[int] = (256, 256, 256),
                 grid_f_dims: Sequence[int] = (256, 128, 64),
                 img_sizes: Sequence[int] = (12, 24, 48),
                 grid_sizes: Sequence[int] = (6, 6, 6)):
        super().__init__()
        gl, gr = assets.load_graph("left"), assets.load_graph("right")
        extras = assets.load_mesh_extras()
        self.img_size_px = img_size_px
        perm = {"left": gl.graph_perm, "right": gr.graph_perm}
        for side, g in (("left", gl), ("right", gr)):
            self.register_buffer(f"perm_{side}",
                                 torch.as_tensor(perm[side], dtype=torch.long),
                                 persistent=False)
            self.register_buffer(f"perm_rev_{side}", torch.as_tensor(
                g.graph_perm_reverse[:778], dtype=torch.long), persistent=False)
        self.v_in = gl.laplacians[0].shape[0]                 # 63
        # vertex positional code: dense mesh colors pooled to 63 vertices
        dc = torch.as_tensor(extras["dense_coor"]) * 2.0 - 1.0   # (778, 3)
        for side in ("left", "right"):
            pe = graph_avg_pool(dc[torch.as_tensor(perm[side]).long()][None],
                                V_ALL // self.v_in)[0]
            self.register_buffer(f"pe_{side}", pe, persistent=False)
        self.register_buffer("upsample",
                             torch.as_tensor(extras["upsample"]),   # (778, 252)
                             persistent=False)

        self.gf_left = nn.Linear(global_feature_dim, gcn_in_dim[0] - 3)
        self.gf_left_ln = nn.LayerNorm(gcn_in_dim[0] - 3, eps=LN_EPS)
        self.gf_right = nn.Linear(global_feature_dim, gcn_in_dim[0] - 3)
        self.gf_right_ln = nn.LayerNorm(gcn_in_dim[0] - 3, eps=LN_EPS)
        for i in range(3):
            img_attn = ((img_sizes[i], img_f_dims[i], grid_sizes[i],
                         grid_f_dims[i]) if use_img_attn else None)
            self.add_module(f"level{i}", DualGraphLayer(
                gcn_in_dim[i], gcn_out_dim[i], gl.laplacians[i],
                gr.laplacians[i], graph_k, num_blocks, n_heads, dropout,
                img_attn))
        v_out = gl.laplacians[2].shape[0]                     # 252
        self.unsample = nn.Linear(v_out, 778, bias=False)
        self.coord_head = nn.Linear(gcn_out_dim[-1], 3)
        self.avg_head = nn.Linear(v_out, 1)
        self.params_head = nn.Linear(gcn_out_dim[-1], 3)
        self.root_head = nn.Linear(gcn_out_dim[-1], 3)

    def _hand_params(self, f: torch.Tensor):
        pooled = self.avg_head(f.transpose(1, 2))[..., 0]        # (B, 64)
        p = self.params_head(pooled)
        return p[:, 0], p[:, 1:], self.root_head(pooled)       # scale, t2d, root

    def forward(self, gf_left: torch.Tensor, gf_right: torch.Tensor,
                fmaps: Optional[List[torch.Tensor]] = None):
        """gf_* (B, 1024); ``fmaps`` the NCHW image pyramid that the image
        attention reads (levels 0-2), None without it."""
        bs = gf_left.shape[0]
        tile = lambda g: g[:, None].expand(bs, self.v_in, g.shape[-1])
        Lf = torch.cat([tile(self.gf_left_ln(self.gf_left(gf_left))),
                        self.pe_left[None].expand(bs, -1, -1)], dim=-1)
        Rf = torch.cat([tile(self.gf_right_ln(self.gf_right(gf_right))),
                        self.pe_right[None].expand(bs, -1, -1)], dim=-1)
        for i in range(3):
            Lf, Rf = getattr(self, f"level{i}")(
                Lf, Rf, None if fmaps is None else fmaps[i])
            if i != 2:
                Lf, Rf = upsample2x_nearest(Lf, 1), upsample2x_nearest(Rf, 1)

        feats = {"left": Lf, "right": Rf}
        result: Dict[str, Any] = {"verts3d": {}, "verts2d": {}}
        other: Dict[str, Any] = {"verts3d_MANO_list": {}, "verts2d_MANO_list": {}}
        params: Dict[str, Any] = {"scale": {}, "trans2d": {}, "root": {}}
        verts_gcn, verts2d_gcn = {}, {}
        for side in ("left", "right"):
            f = feats[side]
            scale, t2d, root = self._hand_params(f)
            params["scale"][side], params["trans2d"][side] = scale, t2d
            params["root"][side] = root
            verts_gcn[side] = self.coord_head(f)                  # (B, 252, 3)
            verts2d_gcn[side] = orthographic_project(
                scale, t2d, verts_gcn[side], self.img_size_px)
            v778 = self.unsample(verts_gcn[side].transpose(1, 2)).transpose(1, 2)
            result["verts3d"][side] = v778
            result["verts2d"][side] = orthographic_project(
                scale, t2d, v778, self.img_size_px)
            perm_rev = getattr(self, f"perm_rev_{side}")
            for key, v in (("verts3d_MANO_list", verts_gcn[side]),
                           ("verts2d_MANO_list", verts2d_gcn[side])):
                up = upsample2x_nearest(upsample2x_nearest(v, 1), 1)  # 1008
                other[key][side] = [up[:, perm_rev]]
        hand_dicts = [{"verts3d": verts_gcn, "verts2d": verts2d_gcn}]
        return result, params, hand_dicts, other
