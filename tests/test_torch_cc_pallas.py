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


# ------------------------------------------------- CPU replay of B9's kernel


def _bits(words):
    """uint32 words (…, n) → bool pixels (…, 32 n), bit i of word k = pixel 32 k + i."""
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=-1,
                         bitorder="little").astype(bool)


def _words(px):
    """bool pixels (…, 32 n) → uint32 words (…, n)."""
    return np.packbits(px, axis=-1, bitorder="little").view(np.uint32)


def _ws_pass_words(L, P):
    """A pass's word phase on staged tiles (…, SH, SWW): the neighbours'
    labelled bits N, S, W, E (W and E carried across words) and the
    candidate words P ∧ ¬L ∧ (N ∨ S ∨ W ∨ E)."""
    z = np.zeros_like(L[..., :1, :])
    nn = np.concatenate([z, L[..., :-1, :]], axis=-2)
    ss = np.concatenate([L[..., 1:, :], z], axis=-2)
    zc = np.zeros_like(L[..., :1])
    left = np.concatenate([zc, L[..., :-1]], axis=-1)
    right = np.concatenate([L[..., 1:], zc], axis=-1)
    ww = (L << 1) | (left >> 31)
    ee = (L >> 1) | (right << 31)
    return (nn, ss, ww, ee), P & ~L & (nn | ss | ww | ee)


_WS_SHIFT = {0: (-1, 0), 1: (1, 0), 2: (0, -1), 3: (0, 1)}  # N, S, W, E as (dy, dx)


def _emulated_ws_sweep(q, mark, mask, levels, inner, max_final, tile=(8, 32), k=4, fault=None):
    """numpy replay of `csrc/watershed.cu` on (B, H, W) quantized heights q:
    labels in place, the L and P bit planes in 32-pixel row words, tiles of
    `tile` (TW a multiple of 32) staged with a halo of k rows and one word,
    phases of k passes (the last of the sweep and of the stabilization cut
    short), each pass's candidate words from the snapshot L and the admitted
    words P ∧ (q ≤ level), its adoptions recording their direction, the early end of a tile's phase when it has
    no candidate, the chains of directions resolved to the labels at the
    phase's end, and the stabilization masks and pass counts. All tiles of a
    phase are staged from one snapshot of the global planes, as the kernel's
    two L planes give, over random directions (what a block's earlier tile
    leaves in shared memory). `fault` plants one defect: "tie_order" (E, W, S, N),
    "gauss_seidel" (rows read the pass's own new bits), "short_halo" (k − 1
    halo rows) or "count" (pass counts one too high)."""
    b, h, w = q.shape
    th, tw = tile
    halo = k - 1 if fault == "short_halo" else k
    sh, sww = th + 2 * halo, tw // 32 + 2
    ty, tx, nwg = -(-h // th), -(-w // tw), -(-w // 32)
    lab = np.where(mask, mark, 0).astype(np.int32)
    big = np.iinfo(np.int32).max
    # global planes, padded so that every staged window is a slice: image
    # row y at halo + y, image word gw at 1 + gw; heights at column 32 + x
    rows, cols = ty * th + 2 * halo, tx * tw // 32 + 2
    Lg = np.zeros((b, rows, cols), np.uint32)
    Pg = np.zeros((b, rows, cols), np.uint32)
    pad_px = np.zeros((b, h, 32 * nwg), bool)
    pad_px[..., :w] = lab > 0
    Lg[:, halo:halo + h, 1:1 + nwg] = _words(pad_px)
    pad_px[..., :w] = mask & (lab == 0)
    Pg[:, halo:halo + h, 1:1 + nwg] = _words(pad_px)
    qg = np.zeros((b, rows, 32 * cols), np.int64)
    qg[:, halo:halo + h, 32:32 + w] = q
    ri = (np.arange(ty) * th)[:, None] + np.arange(sh)             # (TY, SH)
    wi = (np.arange(tx) * (tw // 32))[:, None] + np.arange(sww)    # (TX, SWW)
    ci = (np.arange(tx) * tw)[:, None] + np.arange(32 * sww)       # (TX, SW)
    stage = lambda g, idx: g[:, ri[:, None, :, None], idx[None, :, None, :]]  # (B, TY, TX, SH, ·)
    P = stage(Pg, wi)
    qs = stage(qg, ci)
    q_nb = [np.roll(qs, (-dy, -dx), axis=(-2, -1)) for dy, dx in _WS_SHIFT.values()]  # neighbours' heights
    owned = np.zeros((sh, 32 * sww), bool)
    owned[halo:halo + th, 32:32 + tw] = True
    order = (3, 2, 1, 0) if fault == "tie_order" else (0, 1, 2, 3)
    sweep = levels * inner
    n_sweep, n_stab = -(-sweep // k), -(-max_final // k)
    flags = np.zeros((b, n_stab), np.int64)
    passes = np.zeros(b, np.int32)
    running = np.ones(b, bool)
    stale = np.random.default_rng(0)

    def status(phi):
        """Per image: 1 runs phase phi, 0 stopped before it (pass count set)."""
        out = np.ones(b, np.int32)
        if phi < n_sweep:
            return out
        t = phi - n_sweep
        for i in range(b):
            for u in range(t):
                n = min(k, max_final - u * k)
                if flags[i, u] != (1 << n) - 1:
                    free = ~int(flags[i, u]) & ((1 << 32) - 1)
                    passes[i] = u * k + (free & -free).bit_length() + (fault == "count")
                    out[i] = 0
                    break
            else:
                if t >= n_stab:
                    passes[i] = max_final + (fault == "count")
                    out[i] = 0
        return out

    def adopt(L, r, lvl):
        """Candidates and adoptions of staged rows r (a slice) from the words L:
        the candidate words, and with them the admitted words P ∧ (q ≤ level)."""
        (nn, ss, ww, ee), pend = _ws_pass_words(L, P)
        cand_px = _bits(pend[..., r, :])
        admitted = P[..., r, :] & _words(qs[..., r, :] <= lvl)
        go = _bits(pend[..., r, :] & admitted)
        best = np.full(go.shape, big, np.int64)
        dirs = np.zeros(go.shape, np.int8)
        for d in order:
            nb = _bits((nn, ss, ww, ee)[d][..., r, :])
            qn = q_nb[d][..., r, :]
            better = nb & (qn < best)
            best = np.where(better, qn, best)
            dirs = np.where(better, d, dirs)
        return cand_px.reshape(cand_px.shape[:3] + (-1,)).any(-1), go, dirs

    for phi in range(n_sweep + n_stab + 1):
        st = status(phi)
        running &= st == 1
        if not running.any():
            break
        stab = phi >= n_sweep
        p0 = (phi - n_sweep) * k if stab else phi * k
        n = min(k, (max_final if stab else sweep) - p0)
        L0 = stage(Lg, wi)
        L = L0.copy()
        # directions left in shared memory by the block's previous tile or
        # phase: any values, since a chain reads only this phase's adoptions
        D = stale.integers(0, 4, qs.shape).astype(np.int8)
        live = np.ones(L.shape[:3], bool) & running[:, None, None]
        changed = np.zeros((b, n), bool)
        for j in range(n):
            lvl = big if stab else (p0 + j) // inner
            if fault == "gauss_seidel":
                any_cand = np.zeros(L.shape[:3], bool)
                new_all = np.zeros(qs.shape, bool)
                for r in range(sh):
                    a, go, dirs = adopt(L, slice(r, r + 1), lvl)
                    go &= live[..., None, None]
                    any_cand |= a
                    D[..., r:r + 1, :] = np.where(go, dirs, D[..., r:r + 1, :])
                    new_all[..., r:r + 1, :] = go
                    L[..., r:r + 1, :] |= _words(go)
                new = new_all
            else:
                any_cand, go, dirs = adopt(L, slice(None), lvl)
                new = go & live[..., None, None]
                D = np.where(new, dirs, D)
                L = L | _words(new)
            changed[:, j] = (new & owned).reshape(b, -1).any(-1)
            live &= any_cand  # a tile without a candidate ends its phase
        # owned words out, new owned labels from their chains
        got = _bits(L & ~L0)
        bi, tyi, txi, r, c = np.nonzero(got & owned)
        rr, cc = r.copy(), c.copy()
        done = np.zeros(len(r), bool)
        l0_px = _bits(L0)
        for _ in range(k + 1):
            d = D[bi, tyi, txi, rr, cc]
            step = np.array([_WS_SHIFT[v] for v in range(4)])[d]
            rr = np.where(done, rr, rr + step[:, 0])
            cc = np.where(done, cc, cc + step[:, 1])
            done |= l0_px[bi, tyi, txi, rr, cc]
        assert done.all(), "a chain longer than the phase"
        y_src, x_src = tyi * th + rr - halo, txi * tw + cc - 32
        lab[bi, tyi * th + r - halo, txi * tw + c - 32] = lab[bi, y_src, x_src]
        own = L[..., halo:halo + th, 1:1 + tw // 32]  # (B, TY, TX, TH, TW/32)
        Lg[:, halo:halo + ty * th, 1:1 + tx * tw // 32] = own.transpose(0, 1, 3, 2, 4).reshape(
            b, ty * th, tx * tw // 32)
        Lg[:, halo + h:, :] = 0
        Lg[:, :, 1 + nwg:] = 0
        if stab:
            t = phi - n_sweep
            for i in np.nonzero(running)[0]:
                flags[i, t] = sum(1 << j for j in range(n) if changed[i, j])
    return lab, passes


def _serpentine(b=1, h=100, w=150):
    """A one-pixel path through the image, row by row (≈ h·w/2 pixels long),
    seeded at its start: the stabilization flood outlasts 512 passes."""
    mask = np.zeros((b, h, w), bool)
    mask[:, ::2, :] = True
    for r in range(1, h, 2):
        mask[:, r, w - 1 if r % 4 == 1 else 0] = True
    mark = np.zeros((b, h, w), np.int32)
    mark[:, 0, 0] = 7
    img = np.random.default_rng(9).random((b, h, w)).astype(np.float32)
    return img, mark, mask


def _race(b=1, h=100, w=150):
    """Two one-pixel-wide corridors crossing, a marker near each of their four
    ends, flat relief: the fronts race, and where they meet decides the
    labels, so a front delayed or hurried by one pass shows."""
    mask = np.zeros((b, h, w), bool)
    mask[:, :, 61] = True
    mask[:, 37, :] = True
    mark = np.zeros((b, h, w), np.int32)
    mark[:, 3, 61], mark[:, h - 1, 61], mark[:, 37, 0], mark[:, 37, w - 1] = 1, 2, 3, 4
    return np.zeros((b, h, w), np.float32), mark, mask


def _ws_case(name):
    if name == "pre_grown_negative":
        img, mark, mask = _pre_grown(5, h=100, w=150)
        mark = mark.copy()
        mark[0, 40:44, :] = np.where(mask[0, 40:44, :], -3, 0)  # a negative band: neither changes nor spreads
        return img, mark, mask
    if name == "empty_mask":
        img, mark, mask = _point_seeded(7, h=100, w=150)
        mask[1] = False
        return img, mark * mask, mask
    if name == "serpentine":
        return _serpentine()
    return _point_seeded(5, h=100, w=150)


def _ws_quantized(img, mask, levels):
    from cellvit_tpu_torch.ops import watershed as tws

    return tws.quantize(torch.from_numpy(img), torch.from_numpy(mask), levels).numpy()


@pytest.mark.parametrize("case,kw,tile,k", [
    ("point_seeded", dict(levels=64, inner=4, max_final=512), (8, 32), 4),
    ("point_seeded", dict(levels=64, inner=4, max_final=512), (16, 64), 16),
    ("point_seeded", dict(levels=5, inner=3, max_final=13), (8, 32), 4),
    ("pre_grown_negative", dict(levels=4, inner=1, max_final=3), (16, 64), 8),
    ("pre_grown_negative", dict(levels=300, inner=1, max_final=512), (8, 32), 5),
    ("empty_mask", dict(levels=64, inner=4, max_final=512), (8, 32), 4),
    ("serpentine", dict(levels=1, inner=1, max_final=512), (32, 64), 32),
])
def test_emulated_watershed_kernel_matches_plain_and_pallas(case, kw, tile, k):
    """The replay of `csrc/watershed.cu`'s schedule (words, phases, halos,
    chains, stabilization masks) on floods that cross many tiles and phases
    equals the plain sweep in labels and pass counts, and the Pallas kernel
    in labels: levels, inner passes and caps as the `gpu` test takes them,
    16-bit heights (300 levels), negative markers, an empty mask, and a
    flood cut by the 512-pass cap."""
    from cellvit_tpu_torch.ops import watershed as tws

    img, mark, mask = _ws_case(case)
    q = _ws_quantized(img, mask, kw["levels"])
    got, passes = _emulated_ws_sweep(q, mark, mask, kw["levels"], kw["inner"], kw["max_final"], tile, k)
    want, want_passes = tws.watershed(torch.from_numpy(img), torch.from_numpy(mark), torch.from_numpy(mask),
                                      kw["levels"], kw["inner"], kw["max_final"], schedule="sweep",
                                      return_passes=True)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(passes, want_passes.numpy())
    pallas = _jax_ws(img, mark, mask, levels=kw["levels"], inner_iters=kw["inner"],
                     max_final_iters=kw["max_final"])
    np.testing.assert_array_equal(got, pallas)
    if case == "serpentine":
        assert passes.tolist() == [512] and 0 < (got == 7).sum() < mask.sum()  # cut by the cap
    if case == "pre_grown_negative":
        assert (got[mark < 0] == mark[mark < 0]).all()
    if case == "empty_mask":
        assert (got[1] == 0).all() and passes[1] == 1


@pytest.mark.parametrize("fault", ["tie_order", "gauss_seidel", "short_halo", "count"])
def test_emulated_watershed_kernel_fails_planted_faults(fault):
    """Each planted defect of the replay shows against the plain sweep on
    racing fronts: the tie order reversed, Gauss-Seidel reads within a pass,
    a halo one row short of the phase's passes, pass counts one too high."""
    from cellvit_tpu_torch.ops import watershed as tws

    img, mark, mask = _race()
    levels, inner, cap = 1, 1, 512
    q = _ws_quantized(img, mask, levels)
    want, want_passes = tws.watershed(torch.from_numpy(img), torch.from_numpy(mark), torch.from_numpy(mask),
                                      levels, inner, cap, schedule="sweep", return_passes=True)
    ok, ok_passes = _emulated_ws_sweep(q, mark, mask, levels, inner, cap, (8, 32), 4)
    np.testing.assert_array_equal(ok, want.numpy())
    np.testing.assert_array_equal(ok_passes, want_passes.numpy())
    try:
        got, passes = _emulated_ws_sweep(q, mark, mask, levels, inner, cap, (8, 32), 4, fault=fault)
    except AssertionError:  # a chain of directions longer than the phase: the kernel traps
        assert fault == "gauss_seidel"
        return
    assert (got != want.numpy()).any() or (passes != want_passes.numpy()).any()
