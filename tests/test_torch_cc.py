"""Port's scan ops (plain versions on CPU) bit-exact against the Pallas
kernels in interpret mode, and the port's converging CC / hole filling /
morphology / size filter and cv2-parity filters against their JAX twins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellvit_tpu.ops import cc as jcc
from cellvit_tpu.ops import filters as jfilters
from cellvit_tpu.ops.cc_pallas import (
    compact_root_labels_pallas,
    connected_components_pallas,
    fill_holes_pallas,
    propagate_min_pallas,
)
from cellvit_tpu_torch.ops import cc, cc_cuda, filters

# one intra-op thread each: the suite runs as parallel pytest workers
torch.set_num_threads(1)


def _blobs(rng, b, h, w, n, rmin=2, rmax=7):
    m = np.zeros((b, h, w), bool)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(b):
        for _ in range(n):
            cy, cx = rng.integers(4, h - 4), rng.integers(4, w - 4)
            r = int(rng.integers(rmin, rmax))
            m[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    return m


def _spiral(n, gap=2):
    m = np.zeros((n, n), bool)
    y = x = 0
    m[0, 0] = True
    dirs = ((0, 1), (1, 0), (0, -1), (-1, 0))
    s = 0
    while True:
        length = n - 1 - gap * max(0, (s - 1) // 2)
        if length <= 0:
            return m
        dy, dx = dirs[s % 4]
        for _ in range(length):
            y, x = y + dy, x + dx
            m[y, x] = True
        s += 1


def _shapes(rng):
    """Blobs, a U shape and a spiral (the spiral needs far more than 3 passes)."""
    m = _blobs(rng, 3, 64, 96, 14)
    m[0, 5:40, 5:8] = True
    m[0, 37:40, 5:40] = True
    m[0, 5:40, 37:40] = True
    m[1] = False
    m[1, :48, :48] = _spiral(48)
    return m


@pytest.mark.parametrize("n_outer", [1, 2, 3])
def test_connected_components_plain_bitexact(rng, n_outer):
    m = _shapes(rng)
    want = np.asarray(connected_components_pallas(jnp.asarray(m), n_outer=n_outer,
                                                  interpret=True))
    got = cc_cuda.connected_components_cuda(torch.from_numpy(m), n_outer).numpy()
    np.testing.assert_array_equal(got, want)
    if n_outer == 3:  # the spiral is not converged: several root labels remain
        assert len(np.unique(got[1])) > 2


@pytest.mark.parametrize("n_outer", [1, 2, 3])
def test_fill_holes_plain_bitexact(rng, n_outer):
    m = _shapes(rng)
    m[2, 20:40, 20:40] = True
    m[2, 25:35, 25:35] = False
    want = np.asarray(fill_holes_pallas(jnp.asarray(m), n_outer=n_outer, interpret=True))
    got = cc_cuda.fill_holes_cuda(torch.from_numpy(m), n_outer).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_outer", [1, 2, 3])
def test_propagate_min_and_compact_plain_bitexact(rng, n_outer):
    m = _shapes(rng)
    lab = np.asarray(connected_components_pallas(jnp.asarray(m), n_outer=n_outer,
                                                 interpret=True))
    want = np.asarray(compact_root_labels_pallas(jnp.asarray(lab), n_outer=n_outer,
                                                 interpret=True))
    got = cc_cuda.compact_root_labels_cuda(torch.from_numpy(lab.copy()), n_outer).numpy()
    np.testing.assert_array_equal(got, want)
    seed = rng.integers(0, 1000, m.shape).astype(np.int32)
    want = np.asarray(propagate_min_pallas(jnp.asarray(seed), jnp.asarray(m),
                                           n_outer=n_outer, interpret=True))
    got = cc_cuda.propagate_min_cuda(torch.from_numpy(seed), torch.from_numpy(m), n_outer)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("compact", [False, True])
def test_connected_components_converging(rng, compact):
    m = _shapes(rng)
    m[2] = rng.random((64, 96)) > 0.6
    want = np.asarray(jax.vmap(lambda x: jcc.connected_components(x, compact=compact))(
        jnp.asarray(m)))
    got = cc.connected_components(torch.from_numpy(m), compact=compact).numpy()
    np.testing.assert_array_equal(got, want)


def test_iteration_cap_is_per_image(rng):
    """A capped spiral freezes at its own pass count; the other image
    converges — as a vmapped while_loop does."""
    m = _shapes(rng)[:2]
    want = np.asarray(jax.vmap(lambda x: jcc.connected_components(
        x, max_iters=2, compact=False))(jnp.asarray(m)))
    got = cc.connected_components(torch.from_numpy(m), max_iters=2, compact=False).numpy()
    np.testing.assert_array_equal(got, want)


def test_compact_root_labels_gather(rng):
    m = _shapes(rng)
    lab = np.asarray(connected_components_pallas(jnp.asarray(m), n_outer=3, interpret=True))
    want = np.asarray(jax.vmap(jcc.compact_root_labels)(jnp.asarray(lab)))
    got = cc.compact_root_labels(torch.from_numpy(lab.copy())).numpy()
    np.testing.assert_array_equal(got, want)


def test_fill_holes_converging(rng):
    m = _shapes(rng)
    m[2, 20:40, 20:40] = True
    m[2, 25:35, 25:35] = False
    want = np.asarray(jax.vmap(jcc.fill_holes)(jnp.asarray(m)))
    got = cc.fill_holes(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("min_size", [3, 10])
def test_remove_small_objects_window(rng, min_size):
    m = rng.random((2, 48, 64)) > 0.7
    lab = np.asarray(jax.vmap(jcc.connected_components)(jnp.asarray(m)))
    want = np.asarray(jax.vmap(lambda x: jcc.remove_small_objects_window(x, min_size))(
        jnp.asarray(lab)))
    got = cc.remove_small_objects_window(torch.from_numpy(lab.copy()), min_size).numpy()
    np.testing.assert_array_equal(got, want)


def test_morph_open(rng):
    m = rng.random((2, 48, 48)) > 0.45
    want = np.asarray(jax.vmap(jcc.morph_open)(jnp.asarray(m)))
    got = cc.morph_open(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cc.ELLIPSE_5, jcc.ELLIPSE_5)


@pytest.mark.parametrize("ksize", [11, 21])
def test_sobel(rng, ksize):
    x = rng.random((2, 40, 56)).astype(np.float32)
    for dx, dy in ((1, 0), (0, 1)):
        want = np.asarray(jfilters.sobel(jnp.asarray(x), dx, dy, ksize))
        got = filters.sobel(torch.from_numpy(x), dx, dy, ksize).numpy()
        # coefficients up to 184756 at k=21: compare relative to the range
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=2e-6)


def test_gaussian_and_minmax(rng):
    x = rng.random((2, 32, 48)).astype(np.float32)
    np.testing.assert_allclose(filters.gaussian_blur_3x3(torch.from_numpy(x)).numpy(),
                               np.asarray(jfilters.gaussian_blur_3x3(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    x[1] = 0.25  # constant image: normalises to 0
    np.testing.assert_allclose(filters.minmax_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jfilters.minmax_normalize(jnp.asarray(x))),
                               atol=1e-7)
    for k in (11, 21):
        for a, b in zip(filters.sobel_kernels_1d(k), jfilters.sobel_kernels_1d(k)):
            np.testing.assert_array_equal(a, b)
