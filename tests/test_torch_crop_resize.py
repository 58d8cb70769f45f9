"""The port's ``crop_and_resize`` against the JAX custom VJP: the forward,
and the backward against ``jax.vjp``, within 1e-6, on boxes inside the
image, across its edge and wholly outside it, with two boxes on one image
so that the backward's accumulation is exercised."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu.ops.crop_resize import crop_and_resize as jax_crop_and_resize

from pdfnet_tpu_torch.ops import crop_and_resize
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)

# normalized [y1, x1, y2, x2]
BOXES = np.array([[0.1, 0.2, 0.6, 0.7],       # inside
                  [0.15, 0.1, 0.55, 0.65],    # inside, same image as above
                  [-0.2, 0.5, 0.4, 1.3],      # across the top / right edges
                  [1.1, -0.6, 1.5, -0.1],     # wholly outside
                  [0.7, 0.05, 0.2, 0.45]],    # flipped (y2 < y1), inside
                 np.float32)
BOX_IND = np.array([0, 0, 1, 1, 0], np.int32)


def _image(seed=0):
    return np.random.RandomState(seed).randn(2, 11, 13, 3).astype(np.float32)


@pytest.mark.parametrize("crop_h,crop_w,extrapolation", [
    (7, 7, 0.0), (1, 1, 0.0), (1, 7, -1.5), (5, 1, 0.25)])
def test_crop_and_resize_matches_jax(crop_h, crop_w, extrapolation):
    img = _image()
    g = np.random.RandomState(1).randn(len(BOXES), crop_h, crop_w,
                                       3).astype(np.float32)
    out_j, vjp = jax.vjp(lambda x: jax_crop_and_resize(
        x, jnp.asarray(BOXES), jnp.asarray(BOX_IND), crop_h, crop_w,
        extrapolation), jnp.asarray(img))
    (grad_j,) = vjp(jnp.asarray(g))

    x = torch.from_numpy(img).requires_grad_()
    out = crop_and_resize(x, torch.from_numpy(BOXES),
                          torch.from_numpy(BOX_IND), crop_h, crop_w,
                          extrapolation)
    out.backward(torch.from_numpy(g))
    assert out.shape == (len(BOXES), crop_h, crop_w, 3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad_j), **TOL)
    # the box outside the image is all extrapolation and sends no gradient
    assert np.all(out.detach().numpy()[3] == np.float32(extrapolation))


def test_boxes_on_one_image_accumulate():
    """The gradient of two boxes on one image is the sum of each box's."""
    img = torch.from_numpy(_image(2))
    boxes, ind = torch.from_numpy(BOXES[:2]), torch.zeros(2, dtype=torch.int32)
    grads = []
    for sel in ([0, 1], [0], [1]):
        x = img.clone().requires_grad_()
        crop_and_resize(x, boxes[sel], ind[sel], 7, 7).sum().backward()
        grads.append(x.grad)
    torch.testing.assert_close(grads[0], grads[1] + grads[2], **TOL)
    assert float(grads[1].abs().sum()) > 0 and float(grads[2].abs().sum()) > 0
