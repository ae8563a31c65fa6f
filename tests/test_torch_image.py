"""The port's image layer (pyramid, saliency + NMS, descriptors) against
the JAX package's on the same numpy images. Every function here is
elementwise or a fixed small stencil, so the comparison is to 1e-6
(absolute, on values of order 1) or bitwise where only comparisons and
selections are involved."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photobundle_tpu.image import descriptor as jdesc
from photobundle_tpu.image import pyramid as jpyr
from photobundle_tpu.image import saliency as jsal
from photobundle_torch.image import descriptor as tdesc
from photobundle_torch.image import pyramid as tpyr
from photobundle_torch.image import saliency as tsal

ATOL = 1e-6


def image(seed=0, shape=(37, 52), channels=None):
    rng = np.random.default_rng(seed)
    full = shape if channels is None else (channels, *shape)
    return rng.random(full).astype(np.float32)


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("channels", [None, 3])
def test_blur5_and_downsample(channels):
    img = image(1, channels=channels)
    close(tpyr.gaussian_blur5(torch.as_tensor(img)),
          jpyr.gaussian_blur5(jnp.asarray(img)))
    close(tpyr.downsample2(torch.as_tensor(img)),
          jpyr.downsample2(jnp.asarray(img)))


@pytest.mark.parametrize("sigma", [0.0, 0.5, 0.75, 1.5])
def test_gaussian_blur_sigma(sigma):
    img = image(2, channels=2)
    close(tpyr.gaussian_blur_sigma(torch.as_tensor(img), sigma),
          jpyr.gaussian_blur_sigma(jnp.asarray(img), sigma))


def test_build_pyramid():
    img = image(3, shape=(75, 97))
    t = tpyr.build_pyramid(torch.as_tensor(img), 3)
    j = jpyr.build_pyramid(jnp.asarray(img), 3)
    assert [tuple(a.shape) for a in t] == [a.shape for a in j]
    for a, b in zip(t, j):
        close(a, b)


def test_saliency_maps():
    img = image(4, channels=3)
    close(tsal.gradient_magnitude(torch.as_tensor(img)),
          jsal.gradient_magnitude(jnp.asarray(img)))
    close(tsal.channel_saliency(torch.as_tensor(img)),
          jsal.channel_saliency(jnp.asarray(img)))


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_non_max_suppression_bitwise(radius):
    # Quantized values, as selection feeds NMS, so ties occur.
    s = np.floor(image(5, shape=(41, 53)) * 64.0) / 64.0
    s[0, :7] = 0.9          # a plateau on the border
    t = tsal.non_max_suppression(torch.as_tensor(s), radius, 0.2)
    j = jsal.non_max_suppression(jnp.asarray(s), radius, 0.2)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("descriptor",
                         ["Intensity", "IntensityAndGradient", "BitPlanes"])
@pytest.mark.parametrize("gradient_sigma", [0.0, 1.0])
def test_descriptor_level(descriptor, gradient_sigma):
    img = image(6, shape=(48, 64))
    t = tdesc.build_descriptor_level(torch.as_tensor(img), descriptor,
                                     gradient_sigma=gradient_sigma)
    j = jdesc.build_descriptor_level(jnp.asarray(img), descriptor,
                                     gradient_sigma=gradient_sigma)
    for name in ("channels", "grads", "saliency"):
        assert tuple(getattr(t, name).shape) == getattr(j, name).shape, name
        close(getattr(t, name), getattr(j, name))


def test_bitplanes_signs_bitwise():
    """The census comparisons before the post-smoothing are exact."""
    img = image(7, shape=(30, 40))
    t = tdesc.make_channels(torch.as_tensor(img), "BitPlanes", 0.5, 0.0)
    j = jdesc.make_channels(jnp.asarray(img), "BitPlanes", 0.5, 0.0)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_unknown_descriptor_raises():
    with pytest.raises(ValueError, match="descriptor"):
        tdesc.make_channels(torch.zeros(8, 8), "Nope")
