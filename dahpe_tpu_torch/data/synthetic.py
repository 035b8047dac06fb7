"""Procedural hand-pose domains with a controlled photometric domain shift.

The reference's entire value proposition is the target-PCK gain of its
3-step adversarial loop (``train1.py:328-458``) over source-only training
(``train1.py:278-325``). The real RHD/H3D/STB assets it reports that gain on
are not available in this environment, so this module provides an
ASSET-FREE, fully reproducible substitute: two domains drawn from the SAME
generative hand-geometry process whose appearance differs the way a
synthetic→real shift does (polarity, color balance, background statistics,
blur). Source images are labeled; target labels exist only for evaluation —
exactly the unsupervised-DA protocol.

The JAX package's acceptance experiment (``dahpe_tpu/experiments/adaptation.py``,
DA > source-only) runs on these domains; in the port they feed the CLI drills
and ``chip_smoke.py``.

Geometry: 21 keypoints in the reference's Hand21 layout (wrist + 5 fingers
x 4 joints, ``keypoint_dataset.py:115-147``): a fan of fingers around a
jittered wrist with per-finger length/curvature jitter and a bounded global
orientation, rendered as anti-aliased strokes with joint dots. Because the
fingers carry no texture identity, keypoint identity is encoded purely by
pose — the localization task is non-trivial but learnable by a small
backbone at 64x64.

Port of ``dahpe_tpu/data/synthetic.py`` (numpy and PIL): the same renders,
bit for bit.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

from dahpe_tpu_torch.data.datasets.base import Hand21KeypointDataset

# canvas the hands are rendered on before the standard dataset resize
CANVAS = 160

# per-finger fan: base angle offsets (deg) and length factors
_FINGER_ANGLES = (-50.0, -25.0, 0.0, 25.0, 50.0)
_FINGER_LENGTH = (0.80, 1.00, 1.05, 1.00, 0.90)
# joint radii along a finger, as a fraction of the canvas
_JOINT_RADII = (0.14, 0.23, 0.31, 0.38)


def _hand_geometry(rng: np.random.Generator, size: int,
                   content: float = 0.0) -> np.ndarray:
    """21 keypoints (Hand21 order) for one sample, in pixel coordinates.

    ``content`` in [0, 1] moves the POSE DISTRIBUTION itself away from the
    source process (a *content* shift, the regime of the reference's
    RHD→H3D/STB gap where synthetic and real hands differ in shape/pose
    statistics, ``rendered_hand_pose.py:128-162`` vs ``hand_3d_studio.py:63-75``),
    not just the appearance:

    - global orientation biased by ``+45°·content`` — partially outside the
      train-time RandomRotation(±30°) envelope;
    - per-joint angular drift shifted by ``+14°·content`` per joint:
      strongly CURLED fingers, a pose family the source never produces and
      no augmentation can synthesize;
    - fingers ``+12%·content`` longer and the fan ``-35%·content``
      compressed (different hand-shape statistics).

    At ``content=0`` every expression reduces bit-identically to the r3
    source process (adds/multiplies by exact 0.0/1.0, same rng draws).
    """
    c = float(size)
    t = float(content)
    wrist = (
        np.asarray([0.5, 0.62 - 0.05 * t]) * c
        + rng.uniform(-0.06, 0.06, 2) * c
    )
    theta0 = np.deg2rad(rng.uniform(-35.0, 35.0) + 45.0 * t)
    kp = np.empty((21, 2), np.float64)
    kp[0] = wrist
    for f in range(5):
        ang = theta0 + np.deg2rad(
            _FINGER_ANGLES[f] * (1.0 - 0.35 * t) + rng.uniform(-6.0, 6.0)
        )
        drift = np.deg2rad(rng.uniform(-5.0, 5.0) + 14.0 * t)
        length = _FINGER_LENGTH[f] * rng.uniform(0.92, 1.08) * (1.0 + 0.12 * t)
        for j in range(4):
            a = ang + drift * j
            r = _JOINT_RADII[j] * length * c
            # screen y grows downward; fingers point "up" from the wrist
            kp[1 + 4 * f + j] = wrist + r * np.asarray(
                [np.sin(a), -np.cos(a)]
            )
    if t > 0.0:
        # longer+tilted shifted hands can graze the canvas edge; keep every
        # keypoint renderable (labels always match the render)
        np.clip(kp, 0.03 * c, 0.97 * c, out=kp)
    return kp


def _render_mask(kp: np.ndarray, size: int, rng: np.random.Generator,
                 style: float = 0.0):
    """Anti-aliased stroke+dot coverage mask in [0, 1] for the skeleton.

    ``style`` in [0, 1] is the rendering-STYLE half of the content shift:
    strokes thin by ``-40%·style`` and the joint dots shrink from 1.5× the
    stroke width toward 0.8× (at ``style=1`` the dots dissolve into the
    stroke — joint identity must be read from stroke geometry alone, a
    different low-level feature statistic than the source's dotted look).
    ``style=0`` is bit-identical to the r3 renderer.
    """
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    mask = np.zeros((size, size), np.float32)
    thick = 0.016 * size * (1.0 - 0.40 * style)
    dot_factor = 1.5 - 0.7 * style

    def _segment(p, q):
        d = q - p
        L2 = float(d @ d) + 1e-6
        t = np.clip(((xx - p[0]) * d[0] + (yy - p[1]) * d[1]) / L2, 0.0, 1.0)
        px, py = p[0] + t * d[0], p[1] + t * d[1]
        return np.hypot(xx - px, yy - py)

    for f in range(5):
        chain = [0] + [1 + 4 * f + j for j in range(4)]
        for a, b in zip(chain[:-1], chain[1:]):
            dist = _segment(kp[a].astype(np.float32), kp[b].astype(np.float32))
            np.maximum(mask, np.exp(-((dist / thick) ** 2)), out=mask)
    # joint dots, slightly fatter so peaks are localizable
    for i in range(21):
        dist = np.hypot(xx - kp[i, 0], yy - kp[i, 1])
        np.maximum(
            mask, np.exp(-((dist / (dot_factor * thick)) ** 2)), out=mask
        )
    return np.clip(mask, 0.0, 1.0)


def _low_freq_noise(rng: np.random.Generator, size: int, cells: int = 8):
    """Smooth blotchy background field in [-1, 1] (bilinear-upsampled grid)."""
    coarse = rng.standard_normal((cells + 1, cells + 1)).astype(np.float32)
    img = Image.fromarray(coarse, mode="F").resize(
        (size, size), Image.BILINEAR
    )
    out = np.asarray(img, np.float32)
    return out / (np.abs(out).max() + 1e-6)


def render_sample(index: int, *, domain: str, seed: int, size: int = CANVAS,
                  shift: float = 1.0, content: float = 0.0,
                  style: float | None = None):
    """(image uint8 (size,size,3), keypoint2d (21,2) float32) for one index.

    Both domains share the geometry process; only the appearance differs:

    - ``source``: bright warm strokes on a dark, high-frequency-noise
      background (the "rendered/synthetic" look).
    - ``target``: dark cool strokes on a bright, low-frequency textured
      background with mild blur (the "real photo" look) — polarity, color
      balance, background statistics, and sharpness all shifted at once.

    ``shift`` scales the target's distance from the source appearance
    (pixel-space blend of the two renders). ``shift=1`` is the full
    polarity-inverting shift, on which a source model scores PCK ≈ 0 — the
    degenerate regime pseudo-label DA cannot bootstrap from. Real
    synthetic→real gaps (RHD→H3D) leave the source model partially
    competent; the acceptance experiment uses a calibrated moderate shift.

    ``content`` scales a GEOMETRY shift of the target domain (see
    :func:`_hand_geometry`): the target's POSE DISTRIBUTION moves away from
    the source's — a label shift, the regime where marginal feature
    alignment is theoretically harmful. ``style`` scales the rendering-STYLE
    shift (:func:`_render_mask`: thin strokes, dissolving joint dots) — a
    low-level appearance shift with UNCHANGED pose statistics, the regime
    the reference's synthetic→real problem mostly occupies. ``style=None``
    couples it to ``content`` (the combined geometry+style shift of the
    docs/ACCURACY.md content study). Source renders ignore both;
    ``content=0`` reproduces the r3 renders bit-identically.
    """
    geo_rng = np.random.default_rng((seed, 17, index))
    # NOT hash(): Python string hashing is per-process randomized, and the
    # render must be bit-identical across loader workers/hosts
    domain_id = {"source": 0, "target": 1}.get(domain, 2)
    app_rng = np.random.default_rng((seed, 31, index, domain_id))
    is_target = domain == "target"
    t = float(content) if is_target else 0.0
    s = t if style is None else (float(style) if is_target else 0.0)
    kp = _hand_geometry(geo_rng, size, content=t)
    mask = _render_mask(kp, size, geo_rng, style=s)

    def _source_img(rng):
        bg = 35.0 + 18.0 * rng.standard_normal((size, size, 1))
        fg = np.asarray([230.0, 195.0, 160.0])
        return bg * (1.0 - mask[..., None]) + fg * mask[..., None]

    if domain == "source":
        img = _source_img(app_rng)
    elif domain == "target":
        field = _low_freq_noise(app_rng, size)[..., None]
        bg = 205.0 + 28.0 * field + 10.0 * app_rng.standard_normal(
            (size, size, 1)
        )
        fg = np.asarray([55.0, 70.0, 95.0])
        img = bg * (1.0 - mask[..., None]) + fg * mask[..., None]
        # mild defocus: 3x3 box blur via shifted sums
        p = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
        img = sum(
            p[dy:dy + size, dx:dx + size]
            for dy in range(3) for dx in range(3)
        ) / 9.0
        if shift < 1.0:
            img = shift * img + (1.0 - shift) * _source_img(app_rng)
    else:
        raise ValueError(f"unknown domain {domain!r}")
    return (
        np.clip(img, 0, 255).astype(np.uint8),
        kp.astype(np.float32),
    )


class SyntheticHands(Hand21KeypointDataset):
    """Hand21 dataset over the procedural generator.

    ``split='train'`` and ``split='test'`` draw disjoint index ranges from
    the same process. Implements ``_crop_raw`` so the whole device-input
    stack (``fetch_raw`` → :class:`~dahpe_tpu_torch.data.device_store.DeviceDataStore`
    → fused on-device augmentation) works unchanged.
    """

    # procedural: the registry's dataset-root existence check is meaningless
    requires_root = False

    @property
    def cache_identity(self):
        """Extra :mod:`~dahpe_tpu_torch.data.cache` identity: content depends on
        (domain, seed, shift, content), not on any filesystem root."""
        return {"domain": self.domain, "seed": self.seed,
                "shift": self.shift, "content": self.content,
                "style": self.style}

    def __init__(self, root: str = "", *, domain: str = "source",
                 split: str = "train", n: int = 512, seed: int = 0,
                 shift: float = 1.0, content: float = 0.0,
                 style: float | None = None, transforms=None,
                 image_size=(64, 64), heatmap_size=(16, 16), **kwargs):
        if domain not in ("source", "target"):
            raise ValueError(f"unknown domain {domain!r}")
        self.domain = domain
        self.split = split
        self.seed = int(seed)
        self.shift = float(shift)
        self.content = float(content)
        self.style = None if style is None else float(style)
        base = 1_000_000 if split == "test" else 0
        samples = [base + i for i in range(n)]
        super().__init__(root, samples, transforms=transforms,
                         image_size=image_size, heatmap_size=heatmap_size,
                         **kwargs)

    def _crop_raw(self, index: int):
        img, kp = render_sample(
            self.samples[index], domain=self.domain, seed=self.seed,
            shift=self.shift, content=self.content, style=self.style,
        )
        intrinsic = np.asarray(
            [[CANVAS, 0, CANVAS / 2], [0, CANVAS, CANVAS / 2], [0, 0, 1]],
            np.float32,
        )
        return (
            Image.fromarray(img),
            kp,
            intrinsic,
            np.ones(21, np.float32),
        )

    def fetch(self, index: int, rng: np.random.Generator) -> dict:
        """PIL-transform path (host loaders); raw path is :meth:`fetch_raw`."""
        image, keypoint2d, intrinsic_matrix, visible = self._crop_raw(index)
        data = {
            "keypoint2d": keypoint2d,
            "intrinsic_matrix": intrinsic_matrix,
        }
        if self.transforms is not None:
            image, data = self.transforms(image, rng=rng, **data)
        return {
            "image": image,
            "keypoint2d": data["keypoint2d"],
            "visible": visible,
            "intrinsic_matrix": data["intrinsic_matrix"],
        }


class SyntheticHandsSource(SyntheticHands):
    """Registry entry: the labeled synthetic-look source domain."""

    def __init__(self, root: str = "", **kwargs):
        kwargs.setdefault("n", 256 if kwargs.get("split") == "test" else 2048)
        super().__init__(root, domain="source", **kwargs)


class SyntheticHandsTarget(SyntheticHands):
    """Registry entry: the shifted 'real-look' target domain (labels used
    only by evaluation, per the unsupervised-DA protocol).

    Default shift is the calibrated MODERATE gap (0.4: a source-only
    resnet18 lands at PCK ≈ 0.1-0.3 — the regime real synthetic→real gaps
    occupy and the one pseudo-label DA can bootstrap from; at 1.0 the
    polarity-inverting shift zeroes the source model out entirely).
    Override per run with ``DAHPE_SYNTH_SHIFT`` (the CLI has no flag for a
    dataset-specific knob); ``DAHPE_SYNTH_CONTENT`` likewise sets the
    geometry/style *content* shift (default 0 = photometric-only, the r3
    acceptance setting; docs/ACCURACY.md's content-shift study calibrates
    the non-zero regime).
    """

    def __init__(self, root: str = "", **kwargs):
        import os

        kwargs.setdefault("n", 256 if kwargs.get("split") == "test" else 2048)
        kwargs.setdefault(
            "shift", float(os.environ.get("DAHPE_SYNTH_SHIFT", "0.4"))
        )
        kwargs.setdefault(
            "content", float(os.environ.get("DAHPE_SYNTH_CONTENT", "0"))
        )
        env_style = os.environ.get("DAHPE_SYNTH_STYLE")
        if env_style is not None:
            kwargs.setdefault("style", float(env_style))
        super().__init__(root, domain="target", **kwargs)
