"""Plain versions of the port's size filters (B10, B11) and level-sweep
watershed (B9) exactly equal to the JAX package's Pallas kernels in
interpret mode, and the scatter-form size oracles equal to their JAX twins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellvit_tpu.ops import cc as jcc
from cellvit_tpu.ops.cc_pallas import (
    remove_small_objects_bincount_pallas,
    remove_small_objects_pallas,
    watershed_pallas,
)
from cellvit_tpu_torch.ops import cc, cc_cuda

# one intra-op thread each: the suite runs as parallel pytest workers
torch.set_num_threads(1)


def _labels(seed, b=2, h=96, w=128, p=0.35):
    """Compacted 4-connected labels of a noisy mask: many components of
    every size, from single pixels to large branching ones."""
    m = np.random.default_rng(seed).random((b, h, w)) < p
    return cc.connected_components(torch.from_numpy(m)).numpy()


def _disc_relief(rng, b, h, w, n, rmin=5, rmax=11):
    """Disc masks, relief −exp(−r²/R²) per disc (min over discs), and the
    disc centres with their 1-based ids."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((b, h, w), np.float32)
    mask = np.zeros((b, h, w), bool)
    centres = []
    for i in range(b):
        for k in range(n):
            cy, cx = int(rng.integers(rmin + 1, h - rmin - 1)), int(rng.integers(rmin + 1, w - rmin - 1))
            r = int(rng.integers(rmin, rmax))
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            mask[i] |= d2 <= r * r
            img[i] = np.minimum(img[i], -np.exp(-d2 / (r * r)))
            centres.append((i, cy, cx, r, k + 1))
    return img, mask, centres


def _point_seeded(seed, b=2, h=96, w=128, n=8):
    img, mask, centres = _disc_relief(np.random.default_rng(seed), b, h, w, n)
    mark = np.zeros((b, h, w), np.int32)
    for i, cy, cx, _, k in centres:
        mark[i, cy, cx] = k
    return img, mark, mask


def _pre_grown(seed, b=2, h=96, w=128, n=10):
    """HV-style markers: each disc's core (radius R − 3) already labelled,
    cut by the mask and by later discs, as the postprocessing's markers are."""
    img, mask, centres = _disc_relief(np.random.default_rng(seed), b, h, w, n, rmin=6, rmax=12)
    yy, xx = np.mgrid[0:h, 0:w]
    mark = np.zeros((b, h, w), np.int32)
    for i, cy, cx, r, k in centres:
        mark[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= (r - 3) ** 2] = k
    return img, mark * mask, mask


@pytest.mark.parametrize("min_size", [3, 10])
def test_window_size_filter_matches_pallas(min_size):
    lab = _labels(1)
    want = np.asarray(remove_small_objects_pallas(jnp.asarray(lab), min_size, interpret=True))
    got = cc_cuda.remove_small_objects_cuda(torch.from_numpy(lab), min_size).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (got > 0).sum() < (lab > 0).sum()  # the filter removed some and kept some


def test_window_size_filter_min_size_one_is_identity():
    lab = torch.from_numpy(_labels(2, b=1, h=16, w=24))
    assert cc_cuda.remove_small_objects_cuda(lab, 1) is lab
    np.testing.assert_array_equal(np.asarray(remove_small_objects_pallas(
        jnp.asarray(lab.numpy()), 1, interpret=True)), lab.numpy())


@pytest.mark.parametrize("min_size,hi_bins,lo_bins", [(3, 64, 128), (10, 64, 128), (4, 4, 8), (12, 4, 8)])
def test_bincount_size_filter_matches_pallas(min_size, hi_bins, lo_bins):
    """64 × 128 bins hold every id exactly; 4 × 8 bins hold ids < 32 of the
    hundreds of components per image, so every id ≥ 31 counts into the top
    bin (inflated: id 31 is kept whatever its size) and ids ≥ 32 are
    always kept."""
    lab = _labels(3, w=256)
    assert lab.max() > 8 * hi_bins * lo_bins if hi_bins == 4 else lab.max() < hi_bins * lo_bins
    want = np.asarray(remove_small_objects_bincount_pallas(
        jnp.asarray(lab), min_size, hi_bins=hi_bins, lo_bins=lo_bins, interpret=True))
    xla = np.asarray(jax.vmap(lambda x: jcc.remove_small_objects_bincount(
        x, min_size, max_labels=hi_bins * lo_bins, hi_bins=hi_bins))(jnp.asarray(lab)))
    np.testing.assert_array_equal(xla, want)
    t = torch.from_numpy(lab)
    got = cc_cuda.remove_small_objects_bincount_cuda(t, min_size, hi_bins, lo_bins).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        cc.remove_small_objects_bincount(t, min_size, hi_bins * lo_bins, hi_bins).numpy(), want)
    if hi_bins == 4:
        assert ((got >= 32) == (lab >= 32)).all()  # overflow ids always kept
        assert ((got == 31) == (lab == 31)).all()  # the inflated top bin
        assert (got[lab == 0] == 0).all()


def test_radix_histogram_counts_clipped_ids():
    lab = _labels(4, w=256)
    lab[0, 0, :4] = [-3, 40000, 8191, 8192]
    hist = cc_cuda.radix_histogram_cuda(torch.from_numpy(lab), 64, 128).numpy()
    for i in range(lab.shape[0]):
        ids = np.clip(lab[i].ravel(), 0, 8191)  # what the clipping of hi and lo amounts to
        np.testing.assert_array_equal(hist[i].ravel(), np.bincount(ids, minlength=8192))
    assert hist.dtype == np.float32 and hist.shape == (2, 64, 128)


def _jax_ws(img, mark, mask, **kw):
    return np.asarray(watershed_pallas(jnp.asarray(img), jnp.asarray(mark), jnp.asarray(mask),
                                       interpret=True, **kw))


@pytest.mark.parametrize("inputs", ["point_seeded", "pre_grown"])
def test_sweep_watershed_matches_pallas(inputs):
    img, mark, mask = (_point_seeded if inputs == "point_seeded" else _pre_grown)(5)
    got, passes = cc_cuda.watershed_cuda(torch.from_numpy(img), torch.from_numpy(mark),
                                         torch.from_numpy(mask), return_passes=True)
    np.testing.assert_array_equal(got.numpy(), _jax_ws(img, mark, mask))
    assert ((got.numpy() > 0) == mask).mean() > 0.99
    assert passes.dtype == torch.int32 and (passes >= 1).all() and (passes < 512).all()


def test_sweep_watershed_pass_cap_decides():
    """Few levels and inner passes leave the flood unfinished after the
    sweep; 3 stabilization passes then stop it short, per image."""
    img, mark, mask = _point_seeded(6)
    kw = dict(levels=4, inner_iters=1, max_final_iters=3)
    got, passes = cc_cuda.watershed_cuda(torch.from_numpy(img), torch.from_numpy(mark),
                                         torch.from_numpy(mask), return_passes=True, **kw)
    np.testing.assert_array_equal(got.numpy(), _jax_ws(img, mark, mask, **kw))
    assert passes.tolist() == [3, 3]
    full = cc_cuda.watershed_cuda(torch.from_numpy(img), torch.from_numpy(mark),
                                  torch.from_numpy(mask), levels=4, inner_iters=1)
    assert (got != full).any()  # the cap changed the labels


def test_component_sizes_and_scatter_filter_match_jax():
    lab = _labels(7, h=48, w=64)
    lab[0, 0, :5] = [-1, -40, 500, 10**6, 3]  # wrapped, dropped and clamped ids
    n = int(lab[1].max()) + 1
    t = torch.from_numpy(lab)
    want = np.asarray(jax.vmap(lambda x: jcc.component_sizes(x, n))(jnp.asarray(lab)))
    np.testing.assert_array_equal(cc.component_sizes(t, n).numpy(), want)
    for ms in (3, 10):
        want = np.asarray(jax.vmap(lambda x: jcc.remove_small_objects(x, ms, n))(jnp.asarray(lab)))
        np.testing.assert_array_equal(cc.remove_small_objects(t, ms, n).numpy(), want)
