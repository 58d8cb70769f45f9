"""Demo CLI of the PyTorch port: RGB-D pairs -> rendered two-hand mesh
overlays (port of ``pdfnet_tpu/cli/demo.py``).

Equivalent of the reference demo (demo.py:55-443): reads color/depth PNG
pairs, crops to the model resolution with intrinsics folded in, runs the
self-contained RGB-D inference (centers + masks + clouds from the network's
own predictions) at batch 1, and writes mask / skeleton / mesh-overlay
images under ``{out}/{the input's parent folder}``.

Usage:
  python -m pdfnet_tpu_torch.cli.demo --input assets/H2O \\
      [--ckpt outputs/ckpt/default/model_X] [--out outputs/demo] [--limit 3]
  python -m pdfnet_tpu_torch.cli.demo --cpu ...   # on the CPU, not the card

Runs on one CUDA device unless ``--cpu`` is given.  Frame ``i`` samples its
clouds with a generator on the device seeded ``i``.  Without ``--ckpt`` the
weights are random, seeded by ``Config.seed``.
"""

from __future__ import annotations

import argparse
import glob
import os

import cv2
import numpy as np

# H2O egocentric intrinsics (demo.py:133).  NOTE: the reference then swaps
# cx<->cy (demo.py:135-137) — an intentional quirk for this camera where the
# frames are handled in a transposed convention; we reproduce it so outputs
# line up with the reference demo on the same assets.
H2O_INTRINSICS = dict(fx=636.6593017578125, fy=636.251953125,
                      cx=635.283881879317, cy=366.8740353496978)


def load_rgbd(img_path: str):
    """BGR uint8 image and float64 metric depth (the PNG's millimetres /
    1000) of a ``color/`` file and its ``depth/`` twin; raises naming the
    file that cannot be read."""
    image = cv2.imread(img_path)
    if image is None:
        raise FileNotFoundError(f"cannot read color image {img_path}")
    depth_path = img_path.replace("color", "depth")
    depth = cv2.imread(depth_path, cv2.IMREAD_ANYDEPTH)
    if depth is None:
        raise FileNotFoundError(f"cannot read depth image {depth_path} "
                                f"(for {img_path})")
    return image, depth / 1000.0


def demo_intrinsics() -> np.ndarray:
    """H2O_INTRINSICS as K (3, 3) with the reference's cx<->cy swap."""
    i = H2O_INTRINSICS
    return np.array([[i["fx"], 0, i["cy"]], [0, i["fy"], i["cx"]], [0, 0, 1]],
                    np.float32)


def crop_rgbd(image: np.ndarray, depth: np.ndarray, K: np.ndarray, res: int):
    """Center crop of the longer side, scaled to res x res: (image, float64
    depth, K) of the crop; color bilinear, depth nearest."""
    from pdfnet_tpu_torch.data import augment as aug
    H, W = image.shape[:2]
    c = np.array([W / 2.0, H / 2.0], np.float32)
    trans, _ = aug.get_affine_transform(c, max(H, W) * 1.0, 0, (res, res))
    K_img = aug.update_intrinsics(K, trans)
    image_c = cv2.warpAffine(image, trans, (res, res), flags=cv2.INTER_LINEAR)
    depth_c = cv2.warpAffine(depth, trans, (res, res),
                             flags=cv2.INTER_NEAREST)
    return image_c, depth_c, K_img


def build_parser(out: str) -> argparse.ArgumentParser:
    """The flags the JAX demo and serving CLIs share (``out``: the default
    output directory)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="assets/H2O")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--out", default=out)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--res", type=int, default=384)
    ap.add_argument("--sample_num", type=int, default=1024)
    ap.add_argument("--sample_num_level1", type=int, default=512)
    ap.add_argument("--sample_num_level2", type=int, default=128)
    ap.add_argument("--knn_k", type=int, default=64)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    return ap


def setup(args, batch_size: int):
    """(cfg, model, consts, files) of a serving CLI: the JAX CLIs'
    ``Config``, the model on the card (the CPU with ``--cpu``) with random
    weights or ``--ckpt``'s, and the input's sorted ``color/*.png``."""
    from pdfnet_tpu_torch.config import Config
    from pdfnet_tpu_torch.models.handnet import build_model
    from pdfnet_tpu_torch.train.loss import load_loss_consts

    files = sorted(glob.glob(os.path.join(args.input, "color", "*.png")))
    if args.limit:
        files = files[:args.limit]
    if not files:
        raise SystemExit(f"no color/*.png under {args.input}")
    cfg = Config(default_resolution=args.res, batch_size=batch_size,
                 mode="test", sample_num=args.sample_num,
                 sample_num_level1=args.sample_num_level1,
                 sample_num_level2=args.sample_num_level2, knn_k=args.knn_k)
    device = "cpu" if args.cpu else "cuda"
    model = build_model(cfg, device=device)
    if args.ckpt:
        from pdfnet_tpu_torch.train.checkpoint import load_variables
        load_variables(args.ckpt, model)
        print(f"loaded checkpoint {args.ckpt}")
    return cfg, model, load_loss_consts(device), files


def main(argv=None):
    args = build_parser("outputs/demo").parse_args(argv)

    import torch

    from pdfnet_tpu_torch import assets
    from pdfnet_tpu_torch.models.handnet import infer_rgbd
    from pdfnet_tpu_torch.render import render_two_hands
    from pdfnet_tpu_torch.train.loss import eval_outputs
    from pdfnet_tpu_torch.utils.precision import tf32_off
    from pdfnet_tpu_torch.utils.vis import draw_hand_skeleton

    tf32_off()          # float32 is true float32
    cfg, model, consts, img_list = setup(args, 1)
    device = next(model.parameters()).device
    mean = np.asarray(cfg.mean, np.float32)
    std = np.asarray(cfg.std, np.float32)
    faces_l = assets.load_mano("left").faces
    faces_r = assets.load_mano("right").faces
    os.makedirs(args.out, exist_ok=True)
    gen = torch.Generator(device=device)

    for i, img_file in enumerate(img_list):
        image, depth = load_rgbd(img_file)
        image_c, depth_c, K_img = crop_rgbd(image, depth, demo_intrinsics(),
                                            args.res)
        inp = ((image_c.astype(np.float32) / 255.0 - mean) / std)[None]
        K = torch.from_numpy(K_img[None]).to(device)
        out = infer_rgbd(model, inp, depth_c[None].astype(np.float32), K,
                         np.ones((1, 2), np.float32), gen.manual_seed(i))
        other = out[3]
        out = eval_outputs(cfg, consts, *out, {"K_new": K})

        file_id = os.path.basename(img_file)[:-4]
        # outputs grouped by the input's parent folder (reference layout:
        # outputs/color/...)
        out_dir = os.path.join(args.out,
                               os.path.basename(os.path.dirname(img_file)))
        os.makedirs(out_dir, exist_ok=True)
        mask = other["mask"][0].float().cpu().numpy()
        cv2.imwrite(os.path.join(out_dir, f"mask_lr_{file_id}.jpg"),
                    np.clip((mask[..., 0] + mask[..., 1]) * 255, 0,
                            255).astype(np.uint8))
        lms = out["lms21_pred"][0].cpu().numpy()
        bones = draw_hand_skeleton(image_c.copy(), lms[0])
        draw_hand_skeleton(bones, lms[1],
                           os.path.join(out_dir, f"bones_lr_{file_id}.jpg"))
        verts = out["verts_pred"][0]
        rgb, rmask, _ = render_two_hands(verts[0], verts[1], K[0], faces_l,
                                         faces_r, args.res, args.res)
        rgb = rgb.cpu().numpy() * 255
        rmask = rmask.cpu().numpy()[..., None]
        overlay = (rgb[..., ::-1] * rmask +
                   image_c.astype(np.float32) * (1 - rmask)).astype(np.uint8)
        cv2.imwrite(os.path.join(out_dir, f"render_{file_id}.jpg"), overlay)
        print(f"[{i + 1}/{len(img_list)}] {file_id}: wrote mask/bones/render")


if __name__ == "__main__":
    main()
