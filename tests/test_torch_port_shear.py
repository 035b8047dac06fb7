"""PyTorch port, kernels 4 and 5 and the float mode of kernel 3: the plain
versions of ``ops/shear.py`` (``shear_plain``, ``rotate3_plain``,
``rotate3_fused_plain`` on float input) against the JAX package's Pallas
kernels in interpret mode, at the shapes and slopes of
``tests/test_pallas_shear.py``, and the identities the card checks again.

Every comparison is bit-exact: the shears are integer arithmetic on 8.8
fixed point. The CUDA modes run only on the card (``chip_smoke.py`` phase 2
holds them ``torch.equal`` to these plain versions); here the wrappers must
refuse CPU tensors instead of computing the plain version.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from dahpe_tpu.ops.pallas.shear import rotate3_fused_pallas, rotate3_pallas, shear_pallas

from dahpe_tpu_torch.ops import shear


def _u16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.uint16))


def _np(t: torch.Tensor) -> np.ndarray:
    return shear.u16_to_i32(t).numpy()


# tests/test_pallas_shear.py: ShX on (3, 70, 66) with kmax 32, ShY on
# (3, 66, 70) with kmax 28
@pytest.mark.parametrize("axis,slope", [(2, 0.0), (2, 0.3), (2, -0.41422), (2, 0.70711),
                                        (1, 0.0), (1, -0.3), (1, 0.70711)])
def test_shear_plain_matches_pallas_kernel(axis, slope):
    rng = np.random.default_rng(0 if axis == 2 else 1)
    shape, kmax = ((3, 70, 66), 32) if axis == 2 else ((3, 66, 70), 28)
    img = rng.integers(0, 65536, shape)
    ref = shear_pallas(jnp.asarray(img, jnp.uint16), jnp.float32(slope), kmax=kmax, axis=axis,
                       interpret=True)
    got = shear.shear(_u16(img)[None], torch.tensor([slope]), kmax=kmax, axis=axis)
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(_np(got)[0], np.asarray(ref).astype(np.int32))


def test_shear_per_image_slopes_match_vmapped_kernel():
    """A batch with a slope per image is the JAX package's ``vmap``."""
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 65536, (4, 3, 70, 66))
    slopes = rng.uniform(-0.4, 0.4, 4).astype(np.float32)
    got = _np(shear.shear(_u16(imgs), torch.from_numpy(slopes), kmax=16, axis=2))
    for i in range(4):
        ref = shear_pallas(jnp.asarray(imgs[i], jnp.uint16), jnp.float32(slopes[i]), kmax=16,
                           axis=2, interpret=True)
        np.testing.assert_array_equal(got[i], np.asarray(ref).astype(np.int32))


@pytest.mark.parametrize("shape", [(3, 70, 70), (3, 70, 66)], ids=["square", "70x66"])
@pytest.mark.parametrize("a,b", [(0.0, 0.0), (-0.2, 0.38), (0.41421, -0.70710)])
def test_rotate3_plain_matches_pallas_kernel(shape, a, b):
    """``rotate3_pallas`` (tests/test_pallas_shear.py:54, kmax 30/51), also on
    a non-square canvas."""
    img = np.random.default_rng(4).integers(0, 65536, shape)
    ref = rotate3_pallas(jnp.asarray(img, jnp.uint16), jnp.float32(a), jnp.float32(b),
                         kmax_a=30, kmax_b=51, interpret=True)
    got = shear.rotate3(_u16(img)[None], torch.tensor([a]), torch.tensor([b]),
                        kmax_a=30, kmax_b=51)
    np.testing.assert_array_equal(_np(got)[0], np.asarray(ref).astype(np.int32))


def test_rotate3_is_three_shears():
    rng = np.random.default_rng(7)
    canvas = _u16(rng.integers(0, 65536, (3, 2, 45, 41)))
    a, b = torch.tensor([0.3, -0.41, 0.05]), torch.tensor([-0.7, 0.2, 0.6])
    three = shear.shear(shear.shear(shear.shear(canvas, a, kmax=12, axis=2), b, kmax=20, axis=1),
                        a, kmax=12, axis=2)
    np.testing.assert_array_equal(_np(shear.rotate3(canvas, a, b, kmax_a=12, kmax_b=20)),
                                  _np(three))


def test_fused_rotation_is_crop_of_padded_rotate3():
    """``crop(rotate3(pad(to_fixed(x)))) / 256 == rotate3_fused(x)`` for a
    quarter-turn of 0 (``shear.py:179-184``)."""
    size = 40
    pad, ka, kb = shear.rotation_geometry(size)
    crops = np.random.default_rng(8).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    a, b = torch.tensor([0.41, -0.2]), torch.tensor([-0.69, 0.38])
    fixed = F.pad(torch.from_numpy(crops).permute(0, 3, 1, 2).to(torch.int32) * 256, (pad,) * 4)
    rotated = shear.rotate3(shear.i32_to_u16(fixed), a, b, kmax_a=ka, kmax_b=kb)
    composed = shear.u16_to_i32(rotated)[..., pad:pad + size, pad:pad + size].float() / 256.0
    fused = shear.rotate3_fused(torch.from_numpy(crops), a, b, torch.zeros(2, dtype=torch.int32),
                                pad=pad, kmax_a=ka, kmax_b=kb)
    assert torch.equal(composed, fused)


@pytest.mark.parametrize("q", [0, 1, 2, 3])
def test_float_mode_matches_pallas_and_uint8_mode(q):
    """Kernel 3's float32 input: the plain version equals
    ``rotate3_fused_pallas`` on float input (non-integral, so the rounding
    to 8.8 is exercised) and, on integral floats, the uint8 mode."""
    size = 40
    pad, ka, kb = shear.rotation_geometry(size)
    rng = np.random.default_rng(10 + q)
    frac = rng.uniform(-3.0, 258.0, (1, size, size, 3)).astype(np.float32)  # clipped ends too
    crops = rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)
    a, b = np.float32(-0.3), np.float32(0.55)
    kw = dict(pad=pad, kmax_a=ka, kmax_b=kb)
    args = (torch.tensor([a]), torch.tensor([b]), torch.tensor([q], dtype=torch.int32))
    got = shear.rotate3_fused(torch.from_numpy(frac), *args, **kw)[0].numpy()
    x = jnp.rot90(jnp.asarray(frac[0]).transpose(2, 0, 1), k=q, axes=(1, 2))
    ref = rotate3_fused_pallas(x, a, b, interpret=True, **kw)
    np.testing.assert_array_equal(got, np.asarray(ref))
    as_u8 = shear.rotate3_fused(torch.from_numpy(crops), *args, **kw)
    as_f32 = shear.rotate3_fused(torch.from_numpy(crops.astype(np.float32)), *args, **kw)
    assert torch.equal(as_u8, as_f32)


def test_uint16_helpers_round_trip_the_full_range():
    x = torch.tensor([0, 1, 255, 256, 32767, 32768, 40000, 65535], dtype=torch.int32)
    u = shear.i32_to_u16(x)
    assert u.dtype == torch.uint16
    assert torch.equal(shear.u16_to_i32(u), x)


@pytest.mark.parametrize("call", [
    lambda: shear.shear_cuda(torch.zeros((1, 3, 8, 8), dtype=torch.uint16), torch.zeros(1),
                             kmax=4, axis=2),
    lambda: shear.rotate3_cuda(torch.zeros((1, 3, 8, 8), dtype=torch.uint16), torch.zeros(1),
                               torch.zeros(1), kmax_a=4, kmax_b=6),
    lambda: shear.rotate3_fused_cuda(torch.zeros((1, 8, 8, 3)), torch.zeros(1), torch.zeros(1),
                                     torch.zeros(1, dtype=torch.int32), pad=4, kmax_a=4,
                                     kmax_b=6),
], ids=["shear", "rotate3", "rotate3_fused_f32"])
def test_new_modes_never_fall_back(call):
    """The ``*_cuda`` wrappers refuse CPU tensors instead of computing the
    plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_dispatchers_refuse_other_devices_and_dtypes():
    meta = torch.zeros((1, 3, 8, 8), dtype=torch.uint16, device="meta")
    slope = torch.zeros(1, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        shear.shear(meta, slope, kmax=4)
    with pytest.raises(ValueError, match="no kernel"):
        shear.rotate3(meta, slope, slope, kmax_a=4, kmax_b=6)
    with pytest.raises(ValueError, match="uint16"):
        shear.shear(torch.zeros((1, 3, 8, 8), dtype=torch.int32), torch.zeros(1), kmax=4)
