"""Top-level model: encoder -> mid fusion -> dual-hand GCN mesh decoder
(port of ``pdfnet_tpu/models/handnet.py``; reference HandNET_GCN,
intaghand_model.py:14-47).

The module's mode is the JAX ``train`` flag: in training mode BatchNorm
uses batch statistics (unless ``Config.freeze_bn_stats``), dropout is live,
the set abstraction takes its differentiable grouping path and every head
and decoder runs.  With host-built clouds (``choose`` and ``cloud`` given)
the encoder runs whole; without them it is the self-contained RGB-D path of
``infer_rgbd``: one trunk pass, the clouds built on the device from the
predicted mask and the depth between the encoder's image and point phases
(JAX ``handnet.py:60-82``).

The port honours every ``Config`` value the JAX ``HandNet`` reads; it
refuses only the shapes beyond the selection kernel's shared memory
(``check_config``), and ``arch="csp_*"`` with a ValueError, as JAX does:
that detector is ``models.csp.build_csp_model``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from pdfnet_tpu_torch.config import Config
from pdfnet_tpu_torch.models.encoder import FPNEncoder, MidFusion
from pdfnet_tpu_torch.models.gcn_decoder import MeshDecoder
from pdfnet_tpu_torch.models.attention import ImgAttn
from pdfnet_tpu_torch.models.layers import (BatchNorm, CenterHead, Dropout,
                                            L2Norm, StridedUpConv)
from pdfnet_tpu_torch.ops.grouping import KNN_METHODS
from pdfnet_tpu_torch.ops.pointcloud import depth_to_hand_clouds
from pdfnet_tpu_torch.ops.sa import check_selection_shape

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: Config) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def check_config(cfg: Config) -> None:
    """Raise ValueError for an ``arch="csp_*"`` (the CSP detector is
    ``models.csp.build_csp_model``, as in JAX, ``handnet.py:117-122``), a
    ``knn_method`` neither package has or the device limit a value exceeds
    (the selection kernel's shared memory, ``ops.sa.check_selection_shape``;
    k <= N at each level)."""
    if cfg.arch.startswith("csp"):
        raise ValueError(f"arch={cfg.arch!r} is the CSP alternate detector; "
                         "build it with "
                         "pdfnet_tpu_torch.models.csp.build_csp_model")
    if cfg.knn_method not in KNN_METHODS:
        raise ValueError(f"knn_method={cfg.knn_method!r}: not one of "
                         f"{', '.join(KNN_METHODS)}")
    # the selection kernel's device limit (ops.sa.MAX_SMEM), at both
    # set-abstraction levels: N points, S centers, k neighbours
    levels = ((1, "sample_num", cfg.sample_num, cfg.sample_num_level1),
              (2, "sample_num_level1", cfg.sample_num_level1,
               cfg.sample_num_level2))
    for level, field, n, s in levels:
        try:
            check_selection_shape(f"set abstraction level {level}", n, s,
                                  cfg.knn_k)
        except ValueError as e:
            raise ValueError(f"{field}={n}, knn_k={cfg.knn_k}: {e}") from None


class HandNet(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        gd, fd = cfg.global_feature_dim, cfg.fmap_dim
        self.encoder = FPNEncoder(
            heads=cfg.heads, fmap_dim=fd, global_feature_dim=gd,
            heatmap_dim=cfg.heatmap_dim, hand_num=cfg.hand_num,
            resolution=cfg.default_resolution, knn_k=cfg.knn_k,
            num_level1=cfg.sample_num_level1,
            num_level2=cfg.sample_num_level2, ball_radius=cfg.ball_radius,
            ball_radius2=cfg.ball_radius2,
            input_feature_num=cfg.input_feature_num,
            raw_center_decode=cfg.replicate_reference_quirks,
            compute_dtype=compute_dtype(cfg), knn_method=cfg.knn_method,
            fused_trunk=cfg.fused_trunk, s2d_stem=cfg.s2d_stem,
            patch_heads=cfg.patch_heads)
        # decoder-pyramid widths + trunk stages layer3, layer2, layer1
        self.mid = MidFusion((2 * fd, 2 * fd + 1024, 2 * fd + 512, 2 * fd + 256),
                             tuple(cfg.deconv_dims))
        self.decoder = MeshDecoder(
            global_feature_dim=1024, gcn_in_dim=tuple(cfg.gcn_in_dim),
            gcn_out_dim=tuple(cfg.gcn_out_dim), graph_k=cfg.graph_k,
            num_blocks=cfg.graph_layer_num, n_heads=cfg.num_attn_heads,
            dropout=cfg.dropout, img_size_px=cfg.default_resolution,
            use_img_attn=cfg.use_img_attn,
            img_f_dims=tuple(cfg.deconv_dims[:3]),
            grid_f_dims=tuple(cfg.img_dims),
            img_sizes=(cfg.default_resolution // 32,
                       cfg.default_resolution // 16,
                       cfg.default_resolution // 8))
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.frozen = cfg.freeze_bn_stats
        self._dropouts = [m for m in self.modules() if isinstance(m, Dropout)]

    def forward(self, img: torch.Tensor, choose: Optional[torch.Tensor] = None,
                cloud: Optional[torch.Tensor] = None,
                ind: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                depth: Optional[torch.Tensor] = None,
                K: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None,
                point_generator: Optional[torch.Generator] = None):
        """img (B, H, W, 3) normalized RGB (NHWC, as the JAX model takes it),
        choose (B, 2, N) flat pixel indices, cloud (B, 2, N, 3) xyz (or
        (B, 2, N, 6) xyz + normals at ``input_feature_num=6``), ind (B, 2)
        the hand centers' flat indices on the /4 grid (the ground truth at
        train time) or None to decode them from the predicted heatmap;
        ``generator`` feeds dropout at train time.

        Without ``choose`` or ``cloud`` the clouds are built from the
        predicted mask: depth (B, H, W) metric, K (B, 3, 3), valid (B, 2);
        ``point_generator`` (on the model's device) feeds the random point
        sampler (``Config.sample_deterministic`` takes the first in-band
        pixels instead).

        Returns (result, params, hand_dicts, other) as the JAX model does.
        In training mode ``other`` holds ``hms``, ``mask`` and every head of
        ``ret`` in float32 (NHWC); at eval it leaves out what the eval
        outputs never read: no hms, the mask only on the self-contained
        path, and only the heatmap head (with ``use_img_attn`` the hms and
        mask decoders run, as their pyramids feed the image attention).
        """
        cfg = self.cfg
        for m in self._dropouts:
            m.generator = generator
        with torch.autocast(img.device.type, dtype=torch.bfloat16,
                            enabled=cfg.compute_dtype == "bfloat16"):
            if choose is None or cloud is None:
                hms, mask, ret, ind, cached = self.encoder.image_phase(
                    img.permute(0, 3, 1, 2), ind, aux=self.training,
                    need_mask=True, need_fmaps=cfg.use_img_attn)
                # mask channels are [right, left]; the cloud builder wants
                # [left, right], as cloud[:, 0] is the left hand
                mask_lr = mask.detach().flip(1).permute(0, 2, 3, 1)
                choose, cloud, _ok = depth_to_hand_clouds(
                    depth, mask_lr, K, valid, point_generator,
                    cfg.sample_num,
                    with_normals=cfg.input_feature_num == 6,
                    fps_levels=((cfg.sample_num_level1, cfg.sample_num_level2)
                                if cfg.sample_strategy == "FPS" else None),
                    deterministic=cfg.sample_deterministic)
                fuse = self.encoder.point_phase(cached, cloud, choose, ind)
                img_fmaps = [fuse, cached["x2"], cached["x3"], cached["x4"]]
                hms_fmaps, dp_fmaps = cached["hms_fmaps"], cached["dp_fmaps"]
            else:
                (hms, mask, ret, ind, img_fmaps, hms_fmaps,
                 dp_fmaps) = self.encoder(img.permute(0, 3, 1, 2),
                                          cloud.float(), choose, ind,
                                          aux=self.training,
                                          need_fmaps=cfg.use_img_attn)
            # the fmaps feed only ImgAttn (use_img_attn); without it, at
            # train time their BatchNorms still update, as in flax
            gf_left, gf_right, fmaps = self.mid(img_fmaps, hms_fmaps,
                                                dp_fmaps)
        # the mesh decoder stays float32 (Config.mesh_dtype)
        result, params, hand_dicts, other = self.decoder(
            gf_left.float(), gf_right.float(),
            [f.float() for f in fmaps] if cfg.use_img_attn else None)
        nhwc = lambda t: t.float().permute(0, 2, 3, 1)
        # patch heads arrive as (B, 2, C), the values at the centers
        other["ret"] = {k: nhwc(v) if v.dim() == 4 else v.float()
                        for k, v in ret.items()}
        other["ind"] = ind
        if hms is not None:
            other["hms"] = nhwc(hms)
        if mask is not None:
            other["mask"] = nhwc(mask)
        return result, params, hand_dicts, other


def resolve_device(device) -> torch.device:
    """The card unless the caller asks for another device; never falls back
    to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless "
                           "the caller passes device='cpu'")
    return device


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's default kernel init: a normal truncated to two standard
    deviations, variance 1/fan_in, drawn as ``jax.random.truncated_normal``
    draws it (a uniform through the normal's inverse CDF): one pass, where
    ``nn.init.trunc_normal_`` resamples until every draw falls inside."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, \
        (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    w.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=gen)
    w.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """Seeded initialization with the flax model's initializers: lecun-normal
    kernels, zero biases, unit norms, the -4.59 heatmap bias, L2Norm gain
    10, ``ImgAttn.pos_emb`` normal with std 0.02, and a ``MeshDecoder``'s
    unsample layer set from its upsample matrix."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            _lecun_normal_(m.weight, m.weight[0].numel(), gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.ConvTranspose2d, StridedUpConv)):
            _lecun_normal_(m.weight, m.weight.shape[0] * m.weight[0, 0].numel(),
                           gen)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            _lecun_normal_(m.weight, m.weight.shape[0], gen)
        elif isinstance(m, (BatchNorm, nn.LayerNorm)):
            m.reset_parameters()
    for m in model.modules():
        if isinstance(m, CenterHead):
            m.conv1.bias.fill_(m.bias_init_value)
        elif isinstance(m, L2Norm):
            m.weight.fill_(m.scale_init)
        elif isinstance(m, ImgAttn):
            m.pos_emb.normal_(0.0, 0.02, generator=gen)
        elif isinstance(m, MeshDecoder):
            m.unsample.weight.copy_(m.upsample)


def build_model(cfg: Config, device="cuda") -> HandNet:
    """HandNet with random weights seeded by ``cfg.seed``, in eval mode on
    ``device``: the card by default; raises without one."""
    device = resolve_device(device)
    model = HandNet(cfg)
    init_weights(model, cfg.seed)
    return model.to(device).eval()


def infer_rgbd(model: HandNet, img, depth, K, valid,
               generator: Optional[torch.Generator] = None):
    """Self-contained RGB-D inference (JAX ``infer_rgbd``,
    ``handnet.py:126-140``): centers, masks and point clouds all come from
    the network's own predictions, in one trunk pass.  img (B, H, W, 3)
    normalized RGB, depth (B, H, W) metric, K (B, 3, 3), valid (B, 2);
    numpy arrays or tensors, moved to the model's device.  ``generator`` (on
    that device) feeds the random point sampler.  Runs in eval mode under
    ``torch.inference_mode()``; returns (result, params, hand_dicts, other),
    which ``eval_outputs(cfg, consts, *out, {"K_new": K})`` turns into the
    serving outputs.  Returns before the device finishes, like any CUDA
    call."""
    device = next(model.parameters()).device
    if model.training:
        model.eval()
    with torch.inference_mode():
        img, depth, K, valid = (torch.as_tensor(t, device=device)
                                for t in (img, depth, K, valid))
        return model(img, depth=depth, K=K, valid=valid,
                     point_generator=generator)
