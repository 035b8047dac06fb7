"""PyTorch port, the launch sizing of the two tiled kernels (the rotation
``csrc/rotate3.cu:rotate3_fused_kernel`` and the cluster label kernel
``csrc/pseudo_label.cu``), checked on the CPU where the kernels cannot run:

- the rotation wrapper's shared-memory capacity (``ops/shear.py:
  stage_capacity``) holds the words the kernel bounds each 32 x 32 output
  tile by, and every tap a brute-force numpy walk of ``walk3`` reaches lies
  in the tile's footprint, for the path's extreme slopes and sizes 288, 256
  and 100 (the footprint is in the turned canvas's coordinates, the same for
  every quarter-turn);
- the label launch geometry (``ops/pseudo_label.py:launch_geometry``) covers
  each element of a map exactly once and stays within 227 KB of shared
  memory, or turns staging off, for every ``S² <= 8192`` and ``K <= 64``;
- ``pseudo_labels(..., with_gt=False)`` gives the full call's GF and the
  Pallas kernel's (interpret mode), at ``tests/test_pallas_pseudo_label.py``'s
  tolerances (atol 1e-6, 1e-5 with a fused target).

- the Gaussian kernel (``csrc/render_gaussian.cu``): a numpy transliteration
  of its launch plan and its blocks (zeros over a run of the map each, then
  the values of the windows of the rows it touches, cut to the run, from
  the window table) zeroes every element of the map once and gives
  ``render_gaussian_plain``'s map bit for bit; the table equals the plain
  formula; the plain version matches the Pallas kernel (interpret mode) on
  the odd shapes, reaches, peaks and flags ``chip_smoke.py`` holds the
  kernel to;
- the uint16 rotation (``csrc/rotate3.cu:rotate3_u16_kernel``) stages the
  same words: the capacity holds every tile's words, and a brute-force walk
  lies in each tile's footprint, on the 412² canvas and on non-square ones.

The kernels themselves are held against their plain versions on the card by
``chip_smoke.py`` phase 2.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dahpe_tpu.ops.pallas.gaussian import render_gaussian_pallas
from dahpe_tpu.ops.pallas.pseudo_label import pseudo_labels_pallas

from dahpe_tpu_torch.ops import _build, gaussian, pseudo_label, shear

A_MAX, B_MAX = np.float32(np.tan(np.pi / 8)), np.float32(np.sin(np.pi / 4))


def _shift(slope, line, center, kmax):
    """``csrc/rotate3.cu:line_shear``'s integer shift, in float32."""
    s = np.float32(slope) * (np.asarray(line, np.float32) - np.float32(center))
    return np.clip(np.floor(s).astype(np.int64) + kmax, 0, 2 * kmax) - kmax


def _fused_frame(size):
    """``csrc/rotate3.cu:Frame`` of ``rotate3_fused``: the n x n turned,
    padded canvas, the image at rows and columns ``[pad, pad + size)``, the
    output (the crop) at offset ``pad``; with the shift bounds."""
    pad, kmax_a, kmax_b = shear.rotation_geometry(size)
    n = size + 2 * pad
    return (n, n, pad, pad + size - 1, pad, pad + size - 1), (size, size, pad), (kmax_a, kmax_b)


def _u16_frame(height, width):
    """The same for ``rotate3_u16``: the whole H x W canvas is data and
    output; the shift bounds of the 288² store's canvas."""
    _, kmax_a, kmax_b = shear.rotation_geometry(288)
    return (height, width, 0, height - 1, 0, width - 1), (height, width, 0), (kmax_a, kmax_b)


def _walk_taps(frame, output, kmax, a, b):
    """Every line ``walk3`` visits for every output pixel, in ``P``'s
    coordinates (for ``rotate3_fused``, any quarter-turn: the image sits at
    the same rows and columns of ``P``), keyed by the index of the pixel's
    32 x 32 output tile: ``"cols2"``, the S2 columns inside the canvas, as
    ``(tile, c2)``; ``"rows1"``, the S1 rows inside the canvas, as
    ``(tile, r1)``; ``"taps"``, the taps inside the image, as ``(tile, i, j)``.
    Rows shear about the middle row, columns about the middle column."""
    (n_h, n_w, top, bottom, left, right), (out_h, out_w, off), (kmax_a, kmax_b) = frame, output, kmax
    c_h, c_w = 0.5 * (n_h - 1), 0.5 * (n_w - 1)
    yo, xo = np.meshgrid(np.arange(out_h), np.arange(out_w), indexing="ij")
    tiles_x = -(-out_w // shear.TILE)
    tile = ((yo // shear.TILE) * tiles_x + xo // shear.TILE).ravel()
    row, col = (yo + off).ravel(), (xo + off).ravel()
    out = {"cols2": [], "rows1": [], "taps": []}
    d3 = _shift(a, row, c_h, kmax_a)
    for t in (0, 1):
        c2 = col + d3 + t
        in2 = (c2 >= 0) & (c2 < n_w)
        out["cols2"].append((tile[in2], c2[in2]))
        d2 = _shift(b, c2, c_w, kmax_b)
        for u in (0, 1):
            r1 = row + d2 + u
            in1 = in2 & (r1 >= 0) & (r1 < n_h)
            out["rows1"].append((tile[in1], r1[in1]))
            d1 = _shift(a, r1, c_h, kmax_a)
            for v in (0, 1):
                j = c2 + d1 + v
                ok = in1 & (r1 >= top) & (r1 <= bottom) & (j >= left) & (j <= right)
                out["taps"].append((tile[ok], r1[ok], j[ok]))
    return {key: tuple(np.concatenate(p) for p in zip(*parts)) for key, parts in out.items()}


def _footprint(frame, kmax, a, b, r0, r1, c0, c1):
    """Transliteration of ``csrc/rotate3.cu:tile_footprint`` for the output
    tile at rows ``[r0, r1]`` and columns ``[c0, c1]`` of ``P``: the S2
    columns ``(c2lo, c2hi)`` cut to the canvas, the S1 rows ``(s1lo,
    rows1)``, and the box ``(i0, j0, h, w)`` of ``P`` cut to the image (None
    when empty)."""
    (n_h, n_w, top, bottom, left, right), (kmax_a, kmax_b) = frame, kmax
    c_h, c_w = 0.5 * (n_h - 1), 0.5 * (n_w - 1)
    e = _shift(a, [r0, r1], c_h, kmax_a)
    c2lo, c2hi = max(c0 + e.min(), 0), min(c1 + e.max() + 1, n_w - 1)
    if c2lo > c2hi:
        return (c2lo, c2hi), (0, 0), None
    g = _shift(b, [c2lo, c2hi], c_w, kmax_b)
    s1lo = r0 + g.min()
    rows1 = r1 + g.max() + 1 - s1lo + 1
    rlo, rhi = max(s1lo, top), min(s1lo + rows1 - 1, bottom)
    if rlo > rhi:
        return (c2lo, c2hi), (s1lo, rows1), None
    h = _shift(a, [rlo, rhi], c_h, kmax_a)
    jlo, jhi = max(c2lo + h.min(), left), min(c2hi + h.max() + 1, right)
    box = None if jlo > jhi else (rlo, jlo, rhi - rlo + 1, jhi - jlo + 1)
    return (c2lo, c2hi), (s1lo, rows1), box


def _check_tiles(frame, output, kmax, a, b, capacity, raw_rows_fit):
    """Every output tile: the words the kernel bounds it by fit
    ``capacity``, ``raw_rows_fit(h, w)`` holds for its box, and the
    brute-force walk's S2 columns, S1 rows and taps lie in its footprint."""
    out_h, out_w, off = output
    tiles_x = -(-out_w // shear.TILE)
    walk = _walk_taps(frame, output, kmax, a, b)
    for t in range(tiles_x * -(-out_h // shear.TILE)):
        ty0, tx0 = (t // tiles_x) * shear.TILE, (t % tiles_x) * shear.TILE
        ty1, tx1 = min(ty0 + shear.TILE, out_h) - 1, min(tx0 + shear.TILE, out_w) - 1
        (c2lo, c2hi), (s1lo, rows1), box = _footprint(frame, kmax, a, b, ty0 + off, ty1 + off,
                                                      tx0 + off, tx1 + off)
        cols2 = max(c2hi - c2lo + 1, 0)
        assert shear.stage_words(cols2, ty1 - ty0 + 1, rows1) <= capacity, (t, cols2, rows1)
        tile2, c2 = walk["cols2"]
        assert ((c2lo <= c2[tile2 == t]) & (c2[tile2 == t] <= c2hi)).all(), t
        tile1, r1 = walk["rows1"]
        assert ((s1lo <= r1[tile1 == t]) & (r1[tile1 == t] < s1lo + rows1)).all(), t
        tile_, i, j = walk["taps"]
        ti, tj = i[tile_ == t], j[tile_ == t]
        if ti.size == 0:
            continue
        i0, j0, h, w = box
        assert (i0 <= ti).all() and (ti < i0 + h).all() and (j0 <= tj).all() and (tj < j0 + w).all()
        assert raw_rows_fit(h, w), (t, h, w)


SLOPES = pytest.mark.parametrize("a,b", [(A_MAX, B_MAX), (-A_MAX, B_MAX), (A_MAX, -B_MAX),
                                          (-A_MAX, -B_MAX)], ids=["++", "-+", "+-", "--"])


@SLOPES
@pytest.mark.parametrize("size", [288, 256, 100])
def test_stage_capacity_covers_every_tap(size, a, b):
    """At the path's extreme slopes every tile stages: the words
    ``rotate3_fused_kernel`` bounds its tile by (``shear.stage_words`` of the
    tile's footprint) fit the capacity the wrapper sizes, and so do the raw
    source rows of its box. A brute-force walk of ``walk3`` over every output
    pixel finds each S2 column and S1 row inside the footprint and each tap
    inside the box, so the staged words hold every tap. The footprint lives
    in ``P``'s coordinates, the same for every quarter-turn, whose box the
    raw bytes are checked in both orientations."""
    def raw_rows_fit(h, w):
        return all(rows * (((cols * 3 + 15) // 16 + 1) | 1) * 16 <= shear.stage_raw_bytes(3, 1)
                   for rows, cols in ((h, w), (w, h)))
    frame, output, kmax = _fused_frame(size)
    _check_tiles(frame, output, kmax, a, b, shear.stage_capacity(3), raw_rows_fit)


@SLOPES
@pytest.mark.parametrize("height,width", [(412, 412), (300, 412), (257, 301)],
                         ids=["412x412", "300x412", "257x301"])
def test_stage_capacity_u16_covers_every_tap(height, width, a, b):
    """``rotate3_u16`` at the path's extreme slopes, on the padded canvas of
    the 288² store and on non-square ones (edge tiles cut on both axes): each
    tile's words fit ``stage_capacity`` (the chain of S2 columns and S1 rows
    is bounded by the slopes alone, whatever the canvas), and the
    brute-force walk lies in the footprint (each axis about its own
    centre)."""
    frame, output, kmax = _u16_frame(height, width)
    _check_tiles(frame, output, kmax, a, b, shear.stage_capacity(3), lambda h, w: True)


def test_stage_capacity_fits_shared_memory():
    """The path's footprint: 67 S1 rows of a 67 x 77 box of ``P``; 1666
    packed words staged at most (6.5 KB for uint8, 13 KB for float32 crops)
    beside the source rows' raw bytes (uint8, 18 KB), so six blocks of 256
    threads share an SM with the 11 KB of tables; more than 4 channels walk
    every tile directly. ``rotate3_u16`` stages the same words (8 bytes
    each) beside 8 KB of tables, six blocks an SM too."""
    assert shear.stage_box_shape() == (67, 77)
    assert shear.stage_capacity(3) == shear.stage_words(47, 32, 67) == 1666
    assert shear.stage_capacity(5) == 0 and shear.stage_raw_bytes(5, 1) == 0
    assert shear.stage_raw_bytes(3, 4) == 0
    tables = 256 * (4 + 8 + 16 + 16) + 8 * 4  # csrc/rotate3.cu: line_b .. warp_words
    u8 = (shear.stage_capacity(3) * 4 + 15) // 16 * 16 + shear.stage_raw_bytes(3, 1) + tables
    f32 = shear.stage_capacity(3) * 8 + tables
    assert 6 * max(u8, f32) <= 228 * 1024, (u8, f32)
    u16 = shear.stage_capacity(3) * 8 + 256 * (4 + 8 + 16 + 4) + 8 * 4  # rotate3_u16_kernel
    assert 6 * u16 <= 228 * 1024, u16


def _elements(size, joints):
    """The flat (pixel, joint) indices the kernel's loops visit, from the
    launch geometry: block r of the cluster, thread t keeps joint t % K and
    pixels t // K, t // K + threads // K, ... of its range."""
    geo = pseudo_label.launch_geometry(size, joints)
    threads, chunk, pixels = geo["threads"], geo["pixels"], size * size
    tid = np.arange(threads)
    k, first, step = tid % joints, tid // joints, threads // joints
    seen = []
    for r in range(geo["blocks"]):
        p0 = min(r * chunk, pixels)
        count = min(chunk, pixels - p0)
        for i in range(-(-count // step)):
            p = first + i * step
            ok = p < count
            seen.append((p0 + p[ok]) * joints + k[ok])
    return np.concatenate(seen)


@pytest.mark.parametrize("size,joints", [(s, None) for s in (16, 32, 64, 90)]
                         + [(None, k) for k in (1, 21, 64)])
def test_label_geometry_covers_each_element_once(size, joints):
    """Every element of an S x S x K map is visited by exactly one thread of
    one block, for every K at the path's sizes and every S at K = 1, 21, 64."""
    pairs = ([(size, k) for k in range(1, pseudo_label.MAX_JOINTS + 1)] if joints is None
             else [(s, joints) for s in range(1, 91)])
    for s, k in pairs:
        seen = np.sort(_elements(s, k))
        np.testing.assert_array_equal(seen, np.arange(s * s * k), err_msg=f"S={s} K={k}")


def test_label_geometry_fits_the_block():
    """For every S with S² <= 8192 and every K <= 64: threads a multiple of K
    within 1024, shared memory within 227 KB, and staging only where GF fits
    beside the sum table; the path's shapes all stage."""
    for s in range(1, 91):
        for k in range(1, pseudo_label.MAX_JOINTS + 1):
            geo = pseudo_label.launch_geometry(s, k)
            assert geo["threads"] % k == 0 and k <= geo["threads"] <= 1024
            assert geo["blocks"] * geo["pixels"] >= s * s
            assert geo["shared_bytes"] <= pseudo_label.SHARED_LIMIT
            table = 4 * (-(-geo["pixels"] // 4) * 4)
            fits = table + 4 * geo["pixels"] * k <= pseudo_label.SHARED_LIMIT
            assert geo["staged"] == fits
            assert geo["shared_bytes"] == table + (4 * geo["pixels"] * k if fits else 0)
    assert all(pseudo_label.launch_geometry(s, 21)["staged"] for s in range(1, 91))
    assert not pseudo_label.launch_geometry(90, 64)["staged"]  # the second-pass path


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("gf_kind", ["union_minus", "inverse", "union_others"])
def test_gf_only_matches_full_call_and_pallas(gf_kind, fused):
    rng = np.random.default_rng(20 + len(gf_kind) + fused)
    size, reach, joints = 24, 4, 21
    peaks = rng.integers(-2, size + 2, size=(2, joints, 2)).astype(np.int32)
    target = rng.uniform(0, 1, (2, size, size, joints)).astype(np.float32) if fused else None
    t_target = None if target is None else torch.from_numpy(target)
    for normalize in (True, False):
        kw = dict(out_size=size, reach=reach, gf_kind=gf_kind, normalize=normalize)
        gt, gf = pseudo_label.pseudo_labels(torch.from_numpy(peaks), t_target, **kw)
        none, gf_only = pseudo_label.pseudo_labels(torch.from_numpy(peaks), t_target,
                                                   with_gt=False, **kw)
        assert none is None and gt is not None
        assert torch.equal(gf_only, gf)
        _, gf_ref = pseudo_labels_pallas(jnp.asarray(peaks),
                                         None if target is None else jnp.asarray(target),
                                         interpret=True, **kw)
        np.testing.assert_allclose(gf_only.numpy(), np.asarray(gf_ref),
                                   atol=1e-5 if fused else 1e-6)


# ---- the Gaussian kernel's walk, transliterated

def _cu_constant(name):
    """An integer ``constexpr`` of ``csrc/render_gaussian.cu``."""
    with open(os.path.join(_build.CSRC_DIR, "render_gaussian.cu")) as fh:
        return int(re.search(rf"constexpr int {name} = (\d+);", fh.read()).group(1))


def _floats_per_block(total, sms):
    """``csrc/render_gaussian.cu:floats_per_block``."""
    per = max(-(-total // (sms * _cu_constant("kBlocksPerSm"))), _cu_constant("kMinFloats"))
    return -(-per // 4) * 4


def _window_values(d2, sigma):
    """``expf(-(float)d2 / two_sigma_sq)``: the quotient rounded in float32
    (numpy), the exponential as the plain version takes it (torch)."""
    q = -(np.asarray(d2, np.int64).astype(np.int32).astype(np.float32)) / np.float32(2.0 * sigma**2)
    return torch.exp(torch.from_numpy(np.ascontiguousarray(q, np.float32))).numpy()


def _gaussian_runs(mu, valid, height, width, sigma, reach, sms):
    """Numpy transliteration of ``render_gaussian_kernel``, block by block:
    zeros over the block's run of ``floats_per_block`` floats, then for each
    (row, joint) of the rows the run touches whose window crosses the row
    (64-bit test), the table's value (or the formula's, above
    ``kTableReach``) at each window column whose element lies in the run.
    Returns the map and how many times each element was zeroed."""
    b, joints = valid.shape
    row_len, total = width * joints, valid.shape[0] * height * width * joints
    per = _floats_per_block(total, sms)
    mu = mu.astype(np.int64)
    use_table = 0 <= reach <= _cu_constant("kTableReach")
    table = _window_values(np.arange(2 * reach * reach + 1), sigma) if use_table else None
    out = np.full(total, np.nan, np.float32)
    zeroed = np.zeros(total, np.int64)
    for g0 in range(0, total, per):
        n = min(per, total - g0)
        run = out[g0:g0 + n]
        run[:] = 0.0
        zeroed[g0:g0 + n] += 1
        row0 = g0 // row_len
        rows = (g0 + n - 1) // row_len - row0 + 1
        r, k = np.divmod(np.arange(rows * joints), joints)
        row = row0 + r
        bb, y = np.divmod(row, height)
        dy = y - mu[bb, k, 1]
        hit = (valid[bb, k] > 0) & (dy >= -reach) & (dy <= reach)
        mx, base = mu[bb, k, 0], row * row_len + k - g0
        lo = np.maximum(np.maximum(mx - reach, 0), -(base // joints))  # ceil(-base / K)
        hi = np.minimum(np.minimum(mx + reach, width - 1), np.floor_divide(n - 1 - base, joints))
        for i in np.flatnonzero(hit & (lo <= hi)):
            x = np.arange(lo[i], hi[i] + 1)
            d2 = ((x - mx[i]) ** 2 + dy[i] ** 2) % 2**32
            if use_table:
                assert (d2 <= 2 * reach * reach).all()
                run[base[i] + x * joints] = table[d2]
            else:
                run[base[i] + x * joints] = _window_values(d2, sigma)
    return out.reshape(b, height, width, joints), zeroed


def _gaussian_case(name):
    """``(mu, valid, height, width, reach)`` of ``chip_smoke.py``'s Gaussian
    shapes and cases (batch cut to 4 at the path's shapes)."""
    rng = np.random.default_rng(len(name))
    shapes = {"path 64²": (4, 64, 64, 21, 6), "path 32²": (4, 32, 32, 21, 4),
              "path 16²": (4, 16, 16, 21, 3), "H != W": (4, 48, 40, 21, 6),
              "K = 5, odd W": (3, 17, 31, 5, 4), "W K = 3": (2, 5, 3, 1, 1),
              "B = 1": (1, 64, 64, 21, 6), "reach 0": (8, 32, 32, 21, 0),
              "reach 14 > map": (4, 12, 10, 21, 14), "reach 20, beyond the table": (4, 16, 16, 21, 20),
              "K = 512": (2, 24, 20, 512, 5), "far-off peaks": (4, 32, 32, 21, 6),
              "NaN and negative valid": (4, 32, 32, 21, 6)}
    b, h, w, k, reach = shapes[name]
    mu = np.stack([rng.integers(-8, w + 8, size=(b, k)), rng.integers(-8, h + 8, size=(b, k))],
                  axis=-1).astype(np.int32)
    valid = (rng.uniform(size=(b, k)) > 0.2).astype(np.float32)
    if name == "far-off peaks":
        far = np.array([2**31 - 1, -(2**31) + 2**20, 10**6, -10**6, 40, -7])
        mu.reshape(-1)[::3] = np.resize(far, mu.reshape(-1)[::3].shape)
        valid[:] = 1.0
    if name == "NaN and negative valid":
        valid = np.resize(np.array([np.nan, -1.0, 0.5, 2.0, 0.0, -0.0, np.inf], np.float32), (b, k))
    return mu, valid, h, w, reach


GAUSSIAN_CASES = ["path 64²", "path 32²", "path 16²", "H != W", "K = 5, odd W", "W K = 3",
                  "B = 1", "reach 0", "reach 14 > map", "reach 20, beyond the table", "K = 512",
                  "far-off peaks", "NaN and negative valid"]


@pytest.mark.parametrize("sms", [132, 1], ids=["132 SMs", "1 SM"])
@pytest.mark.parametrize("name", GAUSSIAN_CASES)
def test_gaussian_runs_match_plain(name, sms):
    """The kernel's runs zero each element of the map once and, with the
    windows' values, reproduce ``render_gaussian_plain`` bit for bit: on the
    H100's 132 SMs (runs of a few rows, most starting inside a row) and on
    one (four runs, which cut windows between blocks)."""
    mu, valid, h, w, reach = _gaussian_case(name)
    got, zeroed = _gaussian_runs(mu, valid, h, w, 2.0, reach, sms)
    ref = gaussian.render_gaussian_plain(torch.from_numpy(mu), torch.from_numpy(valid),
                                         height=h, width=w, sigma=2.0, reach=reach).numpy()
    assert (zeroed == 1).all(), np.unique(zeroed)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    if name.startswith("path"):
        assert (got > 0).any() and (got == 0).any()


@pytest.mark.parametrize("sigma", [2.0, 1.5, 0.7])
@pytest.mark.parametrize("reach", [0, 3, 6, 16])
def test_gaussian_table_matches_plain_formula(reach, sigma):
    """Entry ``d2`` of the kernel's table (``expf(-(float)d2 / two_sigma_sq)``,
    the quotient rounded in float32) equals the plain version's formula at
    every ``d2 <= 2 reach²``, and the plain map of one peak holds
    ``table[dx² + dy²]`` at every offset of its window."""
    d2 = np.arange(2 * reach * reach + 1)
    table = _window_values(d2, sigma)
    formula = torch.exp(-torch.from_numpy(d2).to(torch.float32) / gaussian._two_sigma_sq(sigma))
    np.testing.assert_array_equal(table.view(np.int32), formula.numpy().view(np.int32))
    size = 2 * reach + 1
    mu = torch.tensor([[[reach, reach]]], dtype=torch.int32)
    one = gaussian.render_gaussian_plain(mu, torch.ones(1, 1), height=size, width=size,
                                         sigma=sigma, reach=reach)[0, :, :, 0].numpy()
    off = np.arange(size) - reach
    expected = table[off[:, None] ** 2 + off[None, :] ** 2]
    np.testing.assert_array_equal(one.view(np.int32), expected.view(np.int32))


@pytest.mark.parametrize("name", ["H != W", "K = 5, odd W", "W K = 3", "reach 0", "reach 14 > map",
                                  "reach 20, beyond the table", "far-off peaks",
                                  "NaN and negative valid"])
def test_gaussian_plain_matches_pallas_on_odd_cases(name):
    """The plain version against the Pallas kernel (interpret mode) on the
    cases beyond the path's shapes, at ``tests/test_torch_port_core.py``'s
    tolerance: the same zeros, rtol 1e-6 (XLA's and torch's exp). XLA's exp
    flushes results below float32's smallest normal to zero (a reach of 20
    reaches exp(-100)), so zero there means below it."""
    mu, valid, h, w, reach = _gaussian_case(name)
    got = gaussian.render_gaussian_plain(torch.from_numpy(mu), torch.from_numpy(valid),
                                         height=h, width=w, sigma=2.0, reach=reach).numpy()
    ref = np.asarray(render_gaussian_pallas(jnp.asarray(mu), jnp.asarray(valid), height=h,
                                            width=w, sigma=2.0, reach=reach, interpret=True))
    tiny = np.finfo(np.float32).tiny
    np.testing.assert_array_equal(got < tiny, ref < tiny)
    normal = got >= tiny
    np.testing.assert_allclose(got[normal], ref[normal], rtol=1e-6, atol=0)
