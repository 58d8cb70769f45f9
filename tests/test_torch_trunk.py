"""The port's fused eval bottleneck (``pdfnet_tpu_torch.ops.trunk``) against
the JAX Pallas one (``pdfnet_tpu/ops/pallas_trunk.py``) in interpret mode.

On CPU tensors ``fused_bottleneck`` runs its plain version, so these tests
hold the plain version (which ``chip_smoke.py`` in turn holds the CUDA
kernel to, on the card) to the TPU kernel's semantics:

- the BatchNorm fold from the port's modules equals ``fold_bottleneck`` of
  the flax tree carried across by ``convert.from_flax``;
- float32: ``atol=2e-5, rtol=1e-5`` under
  ``jax.default_matmul_precision("highest")``, the JAX package's own bar for
  the fused block against the flax one (sums in another order);
- bfloat16: both round y1, y2, y3 and the shortcut to bf16 after float32
  sums taken in another order, so an element near a rounding boundary can
  land one bf16 step (2**-8 relative) apart and carry that into the next
  product: held to 1e-2 of the output's scale;
- the port's ``ResNet`` with ``fused_eval`` against the JAX ``ResNet`` with
  ``fused_eval=True`` and against its own unfused path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu.models.resnet import Bottleneck as JaxBottleneck
from pdfnet_tpu.models.resnet import ResNet as JaxResNet
from pdfnet_tpu.ops import pallas_trunk

from pdfnet_tpu_torch import convert
from pdfnet_tpu_torch.models.resnet import Bottleneck, ResNet
from pdfnet_tpu_torch.ops import trunk
from test_torch_threads import one_torch_thread  # noqa: F401

TOL_F32 = dict(atol=2e-5, rtol=1e-5)
TOL_BF16 = 1e-2

# the small cases of tests/test_trunk_fused.py: (cin, width, hw, stride,
# project)
CASES = [(64, 64, 24, 1, True),      # layer1 block0 (projected, stride 1)
         (256, 64, 24, 1, False),    # layer1 block1
         (256, 128, 24, 2, True),    # layer2 block0 (stride 2)
         (512, 128, 12, 1, False)]   # layer2 block1 at small spatial


def _random_variables(module, x, rng):
    """Random weights (0.1 randn) and BatchNorm statistics in [0.5, 1.5), as
    ``tests/test_trunk_fused.py`` draws them."""
    # only the shapes are read: no init runs
    vs = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)},
                                            x, train=False))
    stats = jax.tree.map(lambda a: jnp.asarray(
        rng.uniform(0.5, 1.5, a.shape).astype(np.float32)), vs["batch_stats"])
    params = jax.tree.map(lambda a: jnp.asarray(
        (rng.randn(*a.shape) * 0.1).astype(np.float32)), vs["params"])
    return {"params": params, "batch_stats": stats}


def _block(cin, width, stride, project, seed=0):
    """(the JAX fold of a random flax block, the port block with the same
    weights, the numpy generator for the caller's input map)."""
    rng = np.random.RandomState(seed)
    blk = JaxBottleneck(width=width, stride=stride, project=project)
    x = rng.randn(2, 8, 8, cin).astype(np.float32)
    variables = _random_variables(blk, jnp.asarray(x), rng)
    port = Bottleneck(cin, width, stride, project=project).eval()
    port.load_state_dict(convert.from_flax(variables, port))
    folded = pallas_trunk.fold_bottleneck(variables["params"],
                                          variables["batch_stats"])
    return folded, port, rng


def _to_torch(folded):
    return {k: torch.from_numpy(np.array(v)) for k, v in folded.items()}


@pytest.mark.parametrize("cin,width,hw,stride,project", CASES)
def test_fold_matches_jax(cin, width, hw, stride, project):
    folded_j, port, _ = _block(cin, width, stride, project)
    with torch.no_grad():
        folded_t = trunk.fold_bottleneck(port)
    assert sorted(folded_t) == sorted(folded_j)
    for k, v in folded_j.items():
        np.testing.assert_allclose(folded_t[k].numpy(), np.asarray(v),
                                   atol=1e-6, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,width,hw,stride,project", CASES)
def test_fused_bottleneck_plain_matches_pallas(cin, width, hw, stride,
                                               project, dtype):
    folded_j, _, rng = _block(cin, width, stride, project)
    x = rng.randn(2, hw, hw, cin).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = pallas_trunk.fused_bottleneck(
            jnp.asarray(x).astype(dtype), folded_j, stride=stride,
            project=project, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    trunk.reset_launches()
    got = trunk.fused_bottleneck(xt, _to_torch(folded_j), stride, project)
    assert not any(trunk.launches.values())
    assert got.dtype == xt.dtype
    assert got.shape == (2, hw // stride, hw // stride, 4 * width)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, **TOL_F32)
    else:
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= TOL_BF16 * scale


def test_fused_bottleneck_refuses_bad_arguments():
    folded = {"w1": torch.zeros(64, 32), "b1": torch.zeros(32),
              "w2": torch.zeros(3, 3, 32, 32), "b2": torch.zeros(32),
              "w3": torch.zeros(32, 128), "b3": torch.zeros(128)}
    with pytest.raises(ValueError, match="stride 2 is always projected"):
        trunk.fused_bottleneck(torch.zeros(1, 8, 8, 64), folded, 2, False)
    with pytest.raises(ValueError, match="does not fit"):
        trunk.fused_bottleneck(torch.zeros(1, 8, 8, 64), folded, 1, False)
    with pytest.raises(ValueError):
        trunk.fused_bottleneck(torch.zeros(1, 8, 8, 128, device="meta"),
                               {k: v.to("meta") for k, v in folded.items()})


def _resnet_pair(res, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(1, res, res, 3).astype(np.float32)
    variables = _random_variables(JaxResNet(), jnp.asarray(x), rng)
    fused = ResNet(fused_eval=True).eval()
    fused.load_state_dict(convert.from_flax(variables, fused))
    return x, variables, fused


def test_fused_resnet_matches_jax_fused_resnet(monkeypatch):
    """ResNet-50 at eval with the fused blocks on both sides (the JAX ones
    in interpret mode): all five outputs.  The routing fuses the eight
    stride-1 blocks of width >= 128 in stages 1-3, and the ``state_dict``
    is that of the unfused ResNet."""
    monkeypatch.setattr(pallas_trunk, "_TRUNK_INTERPRET", True)
    torch.set_num_threads(1)
    x, variables, fused = _resnet_pair(64, 1)
    assert sorted(fused.fusable) == sorted(
        [f"layer2_{i}" for i in (1, 2, 3)] + [f"layer3_{i}" for i in range(1, 6)])
    assert fused.state_dict().keys() == ResNet().state_dict().keys()
    with jax.default_matmul_precision("highest"):
        ref = JaxResNet(fused_eval=True).apply(variables, jnp.asarray(x),
                                               train=False)
    with torch.inference_mode():
        got = fused(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == 5
    for a, b in zip(ref, got):
        b = b.permute(0, 2, 3, 1).numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(b, np.asarray(a), **TOL_F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_resnet_against_unfused(dtype):
    """The port's ResNet with and without fused eval, same weights: float32
    within TOL_F32; bf16 (autocast, the model's compute dtype) within 1e-2
    of each output's scale, the fused path rounding where the TPU kernel
    does and the unfused where cuDNN's blocks do.  In training mode the
    fused ResNet runs the unfused blocks."""
    torch.set_num_threads(1)
    x, _, fused = _resnet_pair(64, 2)
    plain = ResNet().eval()
    plain.load_state_dict(fused.state_dict())
    img = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode(), torch.autocast(
            "cpu", dtype=torch.bfloat16, enabled=dtype == "bfloat16"):
        got, want = fused(img), plain(img)
    for a, b in zip(got, want):
        a, b = a.float().numpy(), b.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(a, b, **TOL_F32)
        else:
            assert np.abs(a - b).max() <= TOL_BF16 * np.abs(b).max()

    fused.train()
    plain.train()
    with torch.no_grad():
        for a, b in zip(fused(img), plain(img)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


# ResNet-50's routed blocks at 384x384 (layer2_1..3, layer3_1..5) at the
# serving batches, and small maps of the kinds the tests above use:
# (B, H = W, Cin, Cw)
TC_SHAPES = [(8, 48, 512, 128), (8, 24, 1024, 256), (32, 48, 512, 128),
             (32, 24, 1024, 256), (1, 48, 512, 128), (1, 24, 1024, 256),
             (2, 12, 512, 128), (2, 8, 1024, 256), (1, 1, 512, 128)]


@pytest.mark.parametrize("B,hw,cin,cw", TC_SHAPES)
def test_rows_per_block_covers_every_row_once(B, hw, cin, cw):
    """The tensor-core body's row tiles (grid ceil(H / rows), tile t =
    rows [t * rows, min((t + 1) * rows, H))) cover each output row once,
    and the chosen tile fits the block's shared memory."""
    rows = trunk.rows_per_block(B, hw, hw, cin, cw)
    assert 1 <= rows <= hw
    assert trunk.tc_smem_bytes(rows, hw, cw) <= trunk.MAX_SMEM
    seen = np.zeros(hw, int)
    for t in range(-(-hw // rows)):
        seen[t * rows:min((t + 1) * rows, hw)] += 1
    assert (seen == 1).all()


def test_rows_per_block_fills_the_h100_at_the_main_shapes():
    """Batch 8: 3 rows a block at layer2 (128 blocks), 2 at layer3 (96),
    as the source note of csrc/trunk_block.cu states."""
    assert trunk.rows_per_block(8, 48, 48, 512, 128) == 3
    assert trunk.rows_per_block(8, 24, 24, 1024, 256) == 2
    assert trunk.tc_smem_bytes(3, 48, 128) == 188576
    assert trunk.tc_smem_bytes(2, 24, 256) == 161664


def test_tc_shape_guard_names_what_it_refuses():
    res = ResNet()
    for name in res.fusable:                # every block the trunk routes
        blk = getattr(res, name)
        hw = 48 if name.startswith("layer2") else 24
        trunk.check_tc_shape(hw, hw, blk.conv1.in_channels,
                             blk.conv1.out_channels, blk.project)
    with pytest.raises(ValueError, match="unprojected"):
        trunk.check_tc_shape(24, 24, 64, 128, True)
    with pytest.raises(ValueError, match="Cin a multiple of 64"):
        trunk.check_tc_shape(24, 24, 96, 128, False)
    with pytest.raises(ValueError, match="Cw of 128"):
        trunk.check_tc_shape(24, 24, 256, 64, False)
    with pytest.raises(ValueError, match="shared memory"):
        trunk.check_tc_shape(200, 200, 1024, 256, False)


@pytest.mark.parametrize("B,hw,cin,cw", TC_SHAPES)
def test_f32_plan_covers_every_output_pixel_once(B, hw, cin, cw):
    """The float32 body's tiles (grid ceil(H / rows) x ceil(W / tile_w),
    tile t = rows [r0, r0 + rows) x columns [c0, c0 + tile_w) clipped to
    the map, each on one cluster) cover each output pixel once; the tile
    fits the block's shared memory and the cluster divides the channels
    into the body's 128-column passes."""
    rows, tw, cs = trunk.f32_plan(B, hw, hw, cin, cw)
    assert 1 <= rows <= hw and 1 <= tw <= hw and cs in (1, 2)
    assert trunk.f32_smem_bytes(rows, tw, cw) <= trunk.MAX_SMEM
    assert (cw // cs) % trunk.F32_CHANNELS == 0
    assert (cin // cs) % trunk.F32_CHANNELS == 0
    seen = np.zeros((hw, hw), int)
    tiles_w = -(-hw // tw)
    for t in range(-(-hw // rows) * tiles_w):
        r0, c0 = (t // tiles_w) * rows, (t % tiles_w) * tw
        seen[r0:min(r0 + rows, hw), c0:min(c0 + tw, hw)] += 1
    assert (seen == 1).all()


def test_f32_plan_fills_the_h100_at_the_main_shapes():
    """Batch 8: 3 rows a tile at layer2, full width, 128 blocks; 3 rows at
    layer3 on clusters of 2 blocks, 128 blocks; each product's passes sized
    to its rows (240 conv1 rows as 2 x 16 x 8, 144 as 16 x 9; 120 as
    16 x 8, 72 as 16 x 5), as the source note of csrc/trunk_block.cu
    states."""
    assert trunk.f32_plan(8, 48, 48, 512, 128) == (3, 48, 1)
    assert trunk.f32_plan(8, 24, 24, 1024, 256) == (3, 24, 2)
    assert trunk.f32_smem_bytes(3, 48, 128) == 224416
    assert trunk.f32_smem_bytes(3, 24, 256) == 226464
    assert [trunk.f32_pass_rows(m) for m in (240, 144, 120, 72)] == \
        [(2, 8), (1, 9), (1, 8), (1, 5)]
    for m in range(1, 600):
        passes, rm = trunk.f32_pass_rows(m)
        assert rm in trunk.F32_RM
        assert (passes - 1) * 16 * rm < m <= passes * 16 * rm


def test_f32_shape_guard_names_what_it_refuses():
    res = ResNet()
    for name in res.fusable:                # every block the trunk routes
        blk = getattr(res, name)
        hw = 48 if name.startswith("layer2") else 24
        trunk.check_f32_shape(hw, hw, blk.conv1.in_channels,
                              blk.conv1.out_channels, blk.project)
    with pytest.raises(ValueError, match="unprojected"):
        trunk.check_f32_shape(24, 24, 256, 128, True)
    with pytest.raises(ValueError, match="multiples of 128"):
        trunk.check_f32_shape(24, 24, 96, 128, False)
    with pytest.raises(ValueError, match="multiples of 128"):
        trunk.check_f32_shape(24, 24, 256, 64, False)
    with pytest.raises(ValueError, match="shared memory"):
        trunk.check_f32_shape(24, 800, 1024, 1024, False)
    with pytest.raises(ValueError, match="32-bit"):
        trunk.check_f32_shape(4096, 4096, 256, 128, False)
