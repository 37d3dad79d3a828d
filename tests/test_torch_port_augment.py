"""The port's flip + rotation augmentation against the JAX package's.

``rotate_flip_ref`` (K5's plain version) and ``random_augment`` are held
against ``jax.vmap(_rotate_nearest)`` after the flip, the exact function the
TPU kernel stands for: equal on at least 99.9% of pixels, and a pixel may
differ only where a source coordinate lies within 1e-4 of a half-integer,
where the two frameworks' float32 sin, cos and rounding may pick the other
neighbour. Against the TPU kernel ``rotate_flip_pallas`` (interpret mode on
the CPU) they agree on at least 95% of pixels, that kernel's documented
bound (<= ~4% of pixels take a horizontally adjacent source).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmamba_tpu.data.transforms import _rotate_nearest as jax_rotate
from medmamba_tpu.ops.rotate_pallas import rotate_flip_pallas
from medmamba_tpu_torch.data.transforms import (_rotate_nearest, normalize,
                                                preprocess, random_augment,
                                                resize)
from medmamba_tpu_torch.ops import rotate
from medmamba_tpu_torch.ops.rotate import rotate_flip, rotate_flip_ref

MAX_RAD = math.radians(10.0)


def _batch(seed, b, size):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (b, size, size, 3)).astype(np.float32)
    angles = rng.uniform(-MAX_RAD, MAX_RAD, (b,)).astype(np.float32)
    flip = rng.random(b) < 0.5
    return x, angles, flip


def _jax_exact(x, angles, flip):
    xf = np.where(flip[:, None, None, None], x[:, :, ::-1, :], x)
    return np.asarray(jax.vmap(jax_rotate)(jnp.asarray(xf),
                                           jnp.asarray(angles)))


def _check_exact(got, want, angles):
    differ = (got != want).any(-1)                      # (b, h, w)
    assert differ.mean() <= 1e-3, differ.mean()
    b, h, w = differ.shape
    yy = np.arange(h, dtype=np.float64)[:, None] - (h - 1) / 2
    xx = np.arange(w, dtype=np.float64)[None, :] - (w - 1) / 2
    for k in range(b):
        if not differ[k].any():
            continue
        s = float(np.sin(np.float32(angles[k])))
        c = float(np.cos(np.float32(angles[k])))
        ys = c * yy + s * xx + (h - 1) / 2
        xs = -s * yy + c * xx + (w - 1) / 2
        near_half = ((np.abs(ys - np.floor(ys) - 0.5) < 1e-4)
                     | (np.abs(xs - np.floor(xs) - 0.5) < 1e-4))
        assert near_half[differ[k]].all()


@pytest.mark.parametrize("size", [16, 28, 32])
def test_rotate_flip_ref_matches_jax_exact_gather(size):
    x, angles, flip = _batch(size, 6, size)
    got = rotate_flip(torch.from_numpy(x), torch.from_numpy(angles),
                      torch.from_numpy(flip)).numpy()
    _check_exact(got, _jax_exact(x, angles, flip), angles)


def test_rotate_flip_ref_identity_and_flip_at_zero_angle():
    x, _, flip = _batch(1, 4, 20)
    zero = torch.zeros(4)
    got = rotate_flip_ref(torch.from_numpy(x), torch.sin(zero),
                          torch.cos(zero), torch.from_numpy(flip)).numpy()
    want = np.where(flip[:, None, None, None], x[:, :, ::-1, :], x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [28, 48])
def test_rotate_flip_within_the_tpu_kernels_bound(size):
    x, angles, flip = _batch(size + 1, 4, size)
    want = np.asarray(rotate_flip_pallas(jnp.asarray(x), jnp.asarray(angles),
                                         jnp.asarray(flip), max_rad=MAX_RAD))
    got = rotate_flip(torch.from_numpy(x), torch.from_numpy(angles),
                      torch.from_numpy(flip)).numpy()
    assert (got == want).all(-1).mean() >= 0.95


def test_rotate_nearest_matches_jax():
    x, angles, _ = _batch(2, 1, 24)
    got = _rotate_nearest(torch.from_numpy(x[0]),
                          torch.tensor(angles[0])).numpy()
    want = np.asarray(jax_rotate(jnp.asarray(x[0]), jnp.asarray(angles[0])))
    _check_exact(got[None], want[None], angles)


def test_random_augment_draws_from_the_generator():
    """random_augment draws one flip then one angle per image, within
    +/-10 degrees, from the generator it is given: the same draws made by
    hand reproduce it, against the JAX exact gather too."""
    x, _, _ = _batch(3, 8, 28)
    gen = torch.Generator().manual_seed(5)
    got = random_augment(torch.from_numpy(x), gen).numpy()
    gen = torch.Generator().manual_seed(5)
    flip = (torch.rand(8, generator=gen) < 0.5).numpy()
    angles = ((2 * torch.rand(8, generator=gen) - 1) * MAX_RAD).numpy()
    assert np.abs(angles).max() <= MAX_RAD and 0 < flip.sum() < 8
    _check_exact(got, _jax_exact(x, angles, flip), angles)
    again = random_augment(torch.from_numpy(x),
                           torch.Generator().manual_seed(5)).numpy()
    np.testing.assert_array_equal(got, again)


def test_preprocess_augments_at_native_resolution_then_resizes():
    """The JAX order: float32, flip + rotation at the batch's own size,
    resize, normalise."""
    imgs = np.random.default_rng(4).integers(0, 256, (3, 28, 28, 3),
                                             dtype=np.uint8)
    got = preprocess(torch.from_numpy(imgs), size=32, augment=True,
                     generator=torch.Generator().manual_seed(9))
    aug = random_augment(torch.from_numpy(imgs).float(),
                         torch.Generator().manual_seed(9))
    want = normalize(resize(aug, 32))
    assert got.shape == (3, 32, 32, 3) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        preprocess(torch.from_numpy(imgs), size=32, augment=True)


def test_cpu_rotation_leaves_launch_count_at_zero(monkeypatch):
    monkeypatch.setattr(rotate, "LAUNCHES", 0)
    x, angles, flip = _batch(6, 2, 12)
    rotate_flip(torch.from_numpy(x), torch.from_numpy(angles),
                torch.from_numpy(flip))
    assert rotate.LAUNCHES == 0


def test_cuda_rotation_refuses_cpu_tensors():
    """The kernel's wrapper raises on a CPU tensor: nothing falls back."""
    x, angles, flip = _batch(6, 2, 12)
    with pytest.raises(ValueError, match="CUDA"):
        rotate.rotate_flip_cuda(torch.from_numpy(x),
                                torch.sin(torch.from_numpy(angles)),
                                torch.cos(torch.from_numpy(angles)),
                                torch.from_numpy(flip))
