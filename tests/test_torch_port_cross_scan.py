"""The port's CrossScan/CrossMerge against the JAX package's: pure layout
transforms and sums of the same float32 values, so they agree exactly."""
import importlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

# (medmamba_tpu.ops re-exports a function named cross_scan over the module)
jcs = importlib.import_module("medmamba_tpu.ops.cross_scan")
tcs = importlib.import_module("medmamba_tpu_torch.ops.cross_scan")


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape,pad_to", [((2, 3, 5, 4), 0),
                                          ((2, 3, 5, 4), 32),
                                          ((1, 6, 6, 8), 0)])
def test_cross_scan_fwd_matches_jax(shape, pad_to):
    x = _x(0, shape)
    want = np.asarray(jcs.cross_scan_fwd(jnp.asarray(x), pad_to=pad_to))
    got = tcs.cross_scan_fwd(torch.from_numpy(x), pad_to=pad_to).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flip", [True, False])
def test_cross_scan_matches_jax(flip):
    x = _x(1, (2, 3, 5, 4))
    want = np.asarray(jcs.cross_scan(jnp.asarray(x), flip=flip))
    got = tcs.cross_scan(torch.from_numpy(x), flip=flip).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lp", [15, 20])
def test_cross_merge_fr_matches_jax(lp):
    h, w = 3, 5
    yf, yr = _x(2, (2, 2, 4, lp)), _x(3, (2, 2, 4, lp))
    want = np.asarray(jcs.cross_merge_fr(jnp.asarray(yf), jnp.asarray(yr),
                                         h, w))
    got = tcs.cross_merge_fr(torch.from_numpy(yf), torch.from_numpy(yr),
                             h, w).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flipped", [True, False])
def test_cross_merge_matches_jax(flipped):
    h, w = 3, 5
    ys = _x(4, (2, 4, 4, h * w))
    want = np.asarray(jcs.cross_merge(jnp.asarray(ys), h, w, flipped=flipped))
    got = tcs.cross_merge(torch.from_numpy(ys), h, w, flipped=flipped).numpy()
    np.testing.assert_array_equal(got, want)


def test_cross_merge_inverts_cross_scan_per_direction():
    x = _x(5, (2, 3, 5, 4))
    xs = tcs.cross_scan(torch.from_numpy(x))
    merged = tcs.cross_merge(xs, 3, 5)
    want = 4 * torch.from_numpy(x).permute(0, 3, 1, 2).reshape(2, 4, 15)
    torch.testing.assert_close(merged, want, rtol=0, atol=1e-6)
