"""Model-data assets for the port: MANO arrays, GCN graph pyramids, mesh
extras and the 21-joint regressor.

A numpy-only copy of the loaders in ``pdfnet_tpu/assets/__init__.py``
(``load_mano``, ``load_graph``, ``load_mesh_extras``, ``full_regressor``).
The ``.npz`` archives themselves are data shipped with the JAX package; they
are read here by file path, so the port imports nothing of ``pdfnet_tpu``.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple

import numpy as np

ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "pdfnet_tpu", "assets")

# MANO joint re-ordering: wrist, thumb(4), index(4), middle(4), ring(4),
# pinky(4) -> standard 21-joint layout (manolayer.py:110-115).
NEW_ORDER = [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7,
             8, 9, 20]

# Fingertip vertex ids appended after the 16 kinematic joints: ManoLayer uses
# 445 for the left middle fingertip and 444 for the right
# (manolayer.py:305-308); the SMPL-X-style regressor uses 444 for both
# (Mano_model.py:311-316).
TIP_VERTS_LEFT = [745, 317, 445, 556, 673]
TIP_VERTS_RIGHT = [745, 317, 444, 556, 673]
TIP_VERTS_REGRESSOR = [745, 317, 444, 556, 673]


class ManoData(NamedTuple):
    """Dense MANO model arrays (numpy, host-side)."""

    v_template: np.ndarray       # (778, 3)
    shapedirs: np.ndarray        # (778, 3, 10)
    posedirs: np.ndarray         # (778, 3, 135)
    J_regressor: np.ndarray      # (16, 778)
    weights: np.ndarray          # (778, 16)
    hands_components: np.ndarray  # (45, 45)
    hands_mean: np.ndarray       # (45,)
    faces: np.ndarray            # (1538, 3) int32
    parent: np.ndarray           # (16,) int32, parent[0] undefined
    tip_verts: np.ndarray        # (5,) int32
    side: str


class GraphData(NamedTuple):
    """Coarsened-mesh graph pyramid for one hand."""

    laplacians: List[np.ndarray]     # dense L at [63, 126, 252, 504, 1008] verts
    graph_perm: np.ndarray           # (1008,) MANO(padded) -> graph order
    graph_perm_reverse: np.ndarray   # (1008,) graph order -> MANO(padded)
    mesh_faces: np.ndarray           # (1538, 3)


_MANO_CACHE: Dict[str, ManoData] = {}
_GRAPH_CACHE: Dict[str, GraphData] = {}
_EXTRAS_CACHE: Dict[str, np.ndarray] = {}


def load_mano(side: str, fix_shape: bool = True) -> ManoData:
    """Load MANO data for one hand.

    ``fix_shape`` applies the left-hand shapedirs sign fix
    (interhand.py:120-123): the distributed left model's first shape
    direction is mirrored; flip it so left/right differ as intended.
    """
    key = f"{side}:{fix_shape}"
    if key in _MANO_CACHE:
        return _MANO_CACHE[key]
    with np.load(os.path.join(ASSET_DIR, f"mano_{side}.npz")) as z:
        shapedirs = z["shapedirs"]
        if side == "left" and fix_shape:
            with np.load(os.path.join(ASSET_DIR, "mano_right.npz")) as right:
                right_dirs = right["shapedirs"]
            if float(np.abs(shapedirs[:, 0, :] - right_dirs[:, 0, :]).sum()) < 1:
                shapedirs = shapedirs.copy()
                shapedirs[:, 0, :] *= -1
        data = ManoData(
            v_template=z["v_template"],
            shapedirs=shapedirs,
            posedirs=z["posedirs"],
            J_regressor=z["J_regressor"],
            weights=z["weights"],
            hands_components=z["hands_components"],
            hands_mean=z["hands_mean"],
            faces=z["faces"],
            parent=z["kintree_parent"],
            tip_verts=np.asarray(
                TIP_VERTS_LEFT if side == "left" else TIP_VERTS_RIGHT, np.int32),
            side=side,
        )
    _MANO_CACHE[key] = data
    return data


def load_graph(side: str) -> GraphData:
    if side in _GRAPH_CACHE:
        return _GRAPH_CACHE[side]
    with np.load(os.path.join(ASSET_DIR, f"graph_{side}.npz")) as z:
        n = int(z["num_levels"])
        # Stored coarse-to-fine as saved (1008...63); expose fine index 0 = 63
        # to match the decoder's reversed ordering (intaghand_decoder.py:99-100).
        laps = [z[f"L{i}"] for i in range(n)][::-1]
        data = GraphData(
            laplacians=laps,
            graph_perm=z["graph_perm"],
            graph_perm_reverse=z["graph_perm_reverse"],
            mesh_faces=z["mesh_faces"],
        )
    _GRAPH_CACHE[side] = data
    return data


def load_mesh_extras() -> Dict[str, np.ndarray]:
    """Upsample matrix (778x252) and dense vertex color coords (778x3)."""
    if not _EXTRAS_CACHE:
        with np.load(os.path.join(ASSET_DIR, "mesh_extras.npz")) as z:
            _EXTRAS_CACHE["upsample"] = z["upsample"]
            _EXTRAS_CACHE["dense_coor"] = z["dense_coor"]
    return dict(_EXTRAS_CACHE)


def full_regressor(side: str) -> np.ndarray:
    """21x778 joint regressor incl. fingertips (Mano_model.py:309-323)."""
    mano = load_mano(side)
    tips = np.zeros((5, 778), np.float32)
    for i, v in enumerate(TIP_VERTS_REGRESSOR):
        tips[i, v] = 1.0
    reg = np.concatenate([mano.J_regressor, tips], axis=0)
    return reg[NEW_ORDER].copy()
