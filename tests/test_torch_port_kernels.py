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

The kernels themselves are held against their plain versions on the card by
``chip_smoke.py`` phase 2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dahpe_tpu.ops.pallas.pseudo_label import pseudo_labels_pallas

from dahpe_tpu_torch.ops import pseudo_label, shear

A_MAX, B_MAX = np.float32(np.tan(np.pi / 8)), np.float32(np.sin(np.pi / 4))


def _shift(slope, line, center, kmax):
    """``csrc/rotate3.cu:line_shear``'s integer shift, in float32."""
    s = np.float32(slope) * (np.asarray(line, np.float32) - np.float32(center))
    return np.clip(np.floor(s).astype(np.int64) + kmax, 0, 2 * kmax) - kmax


def _walk_taps(size, a, b):
    """Every line ``walk3`` visits for every output pixel, in ``P``'s
    coordinates (any quarter-turn: the image sits at rows and columns
    ``[pad, pad + size)`` of ``P``), keyed by the index of the pixel's
    32 x 32 output tile: ``"cols2"``, the S2 columns inside the canvas, as
    ``(tile, c2)``; ``"rows1"``, the S1 rows inside the canvas, as
    ``(tile, r1)``; ``"taps"``, the taps inside the image, as ``(tile, i, j)``."""
    pad, kmax_a, kmax_b = shear.rotation_geometry(size)
    n, c = size + 2 * pad, 0.5 * (size + 2 * pad - 1)
    yo, xo = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    tiles_x = -(-size // shear.TILE)
    tile = ((yo // shear.TILE) * tiles_x + xo // shear.TILE).ravel()
    row, col = (yo + pad).ravel(), (xo + pad).ravel()
    out = {"cols2": [], "rows1": [], "taps": []}
    d3 = _shift(a, row, c, kmax_a)
    for t in (0, 1):
        c2 = col + d3 + t
        in2 = (c2 >= 0) & (c2 < n)
        out["cols2"].append((tile[in2], c2[in2]))
        d2 = _shift(b, c2, c, kmax_b)
        for u in (0, 1):
            r1 = row + d2 + u
            in1 = in2 & (r1 >= 0) & (r1 < n)
            out["rows1"].append((tile[in1], r1[in1]))
            d1 = _shift(a, r1, c, kmax_a)
            for v in (0, 1):
                j = c2 + d1 + v
                ok = in1 & (r1 >= pad) & (r1 < pad + size) & (j >= pad) & (j < pad + size)
                out["taps"].append((tile[ok], r1[ok], j[ok]))
    return {key: tuple(np.concatenate(p) for p in zip(*parts)) for key, parts in out.items()}


def _footprint(size, a, b, ty0, tx0):
    """Transliteration of ``csrc/rotate3.cu:tile_footprint`` for the output
    tile at ``(ty0, tx0)``: the S2 columns ``(c2lo, c2hi)`` cut to the
    canvas, the S1 rows ``(s1lo, rows1)``, and the box ``(i0, j0, h, w)`` of
    ``P`` cut to the image (None when empty)."""
    pad, kmax_a, kmax_b = shear.rotation_geometry(size)
    n, c = size + 2 * pad, 0.5 * (size + 2 * pad - 1)
    r0, r1 = ty0 + pad, min(ty0 + shear.TILE, size) - 1 + pad
    c0, c1 = tx0 + pad, min(tx0 + shear.TILE, size) - 1 + pad
    e = _shift(a, [r0, r1], c, kmax_a)
    c2lo, c2hi = max(c0 + e.min(), 0), min(c1 + e.max() + 1, n - 1)
    if c2lo > c2hi:
        return (c2lo, c2hi), (0, 0), None
    g = _shift(b, [c2lo, c2hi], c, kmax_b)
    s1lo = r0 + g.min()
    rows1 = r1 + g.max() + 1 - s1lo + 1
    rlo, rhi = max(s1lo, pad), min(s1lo + rows1 - 1, pad + size - 1)
    if rlo > rhi:
        return (c2lo, c2hi), (s1lo, rows1), None
    h = _shift(a, [rlo, rhi], c, kmax_a)
    jlo, jhi = max(c2lo + h.min(), pad), min(c2hi + h.max() + 1, pad + size - 1)
    box = None if jlo > jhi else (rlo, jlo, rhi - rlo + 1, jhi - jlo + 1)
    return (c2lo, c2hi), (s1lo, rows1), box


@pytest.mark.parametrize("a,b", [(A_MAX, B_MAX), (-A_MAX, B_MAX), (A_MAX, -B_MAX),
                                 (-A_MAX, -B_MAX)], ids=["++", "-+", "+-", "--"])
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
    capacity = shear.stage_capacity(3)
    tiles_x = -(-size // shear.TILE)
    walk = _walk_taps(size, a, b)
    for t in range(tiles_x * tiles_x):
        ty0, tx0 = (t // tiles_x) * shear.TILE, (t % tiles_x) * shear.TILE
        tile_rows = min(ty0 + shear.TILE, size) - ty0
        (c2lo, c2hi), (s1lo, rows1), box = _footprint(size, a, b, ty0, tx0)
        cols2 = max(c2hi - c2lo + 1, 0)
        assert shear.stage_words(cols2, tile_rows, rows1) <= capacity, (t, cols2, rows1)
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
        for rows, cols in ((h, w), (w, h)):
            assert rows * (((cols * 3 + 15) // 16 + 1) | 1) * 16 <= shear.stage_raw_bytes(3, 1)


def test_stage_capacity_fits_shared_memory():
    """The path's footprint: 67 S1 rows of a 67 x 77 box of ``P``; 1666
    packed words staged at most (6.5 KB for uint8, 13 KB for float32 crops)
    beside the source rows' raw bytes (uint8, 18 KB), so six blocks of 256
    threads share an SM with the 11 KB of tables; more than 4 channels walk
    every tile directly."""
    assert shear.stage_box_shape() == (67, 77)
    assert shear.stage_capacity(3) == shear.stage_words(47, 32, 67) == 1666
    assert shear.stage_capacity(5) == 0 and shear.stage_raw_bytes(5, 1) == 0
    assert shear.stage_raw_bytes(3, 4) == 0
    tables = 256 * (4 + 8 + 16 + 16) + 8 * 4  # csrc/rotate3.cu: line_b .. warp_words
    u8 = (shear.stage_capacity(3) * 4 + 15) // 16 * 16 + shear.stage_raw_bytes(3, 1) + tables
    f32 = shear.stage_capacity(3) * 8 + tables
    assert 6 * max(u8, f32) <= 228 * 1024, (u8, f32)


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
