"""The plain reference of the training batch producer, in plain PyTorch.

A frozen copy of the published augmentation (``train1.py:56-63`` of the
reference: rotate, random resized crop, colour jitter, Gaussian blur,
normalize) in the batched form the port draws it: every random number of a
batch from one ``torch.rand`` on the domain's generator after a
``torch.randperm`` of the store's rows, so the same generator state gives
the same draws on both sides. The rotation is the exact quarter-turn and
three 8.8 fixed-point shears (Paeth), the crop-resize two interpolation
products, the targets windowed Gaussians at the rounded keypoints.
Nothing here imports the port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def draw(gen, n_rows, b, *, size, rotation, scale_range, jitter=0.25, blur=(0.0, 0.8)):
    """The rows and augmentation draws of one batch, from ``gen``."""
    idx = torch.randperm(n_rows, generator=gen, device=gen.device)[:b]
    u = torch.rand((b, 11), generator=gen, device=gen.device)
    lo, hi = scale_range
    side = torch.sqrt((lo + (hi - lo) * u[:, 1]) * float(size * size))
    side = torch.clamp(torch.round(side), 1.0, float(size))
    i = torch.floor(u[:, 2] * (size - side + 1.0))
    j = torch.floor(u[:, 3] * (size - side + 1.0))
    return idx, {
        "angle": rotation * (2.0 * u[:, 0] - 1.0),
        "side": side,
        "offset": torch.stack([j, i], dim=-1),
        "factors": 1.0 - jitter + 2.0 * jitter * u[:, 4:7],
        "order": torch.argsort(u[:, 7:10], dim=1),
        "radius": blur[0] + (blur[1] - blur[0]) * u[:, 10],
    }


def _shift_rows(image, k, kmax):
    """``out[..., y, x] = image[..., y, x + k[y]]``, zero-filled, one extra column."""
    w = image.shape[-1]
    padded = F.pad(image, (kmax, kmax + 1))
    cols = torch.arange(w + 1, device=image.device)
    src = (cols[None, None, :] + torch.clamp(k, -kmax, kmax)[..., None] + kmax)  # (B, H, w+1)
    src = src[:, None].expand(-1, image.shape[1], -1, -1)
    return torch.gather(padded, -1, src)


def _shear_x(image, slope, kmax):
    h, w = image.shape[-2:]
    y = torch.arange(h, dtype=torch.float32, device=image.device)
    s = slope.to(torch.float32)[:, None] * (y - (h - 1) / 2.0)
    k = torch.floor(s)
    w2 = torch.round((s - k) * 256.0).to(torch.int32)[:, None, :, None]
    base = _shift_rows(image, k.to(torch.int64), kmax)
    return (base[..., :w] * (256 - w2) + base[..., 1:w + 1] * w2 + 128) >> 8


def rotate(images, angle):
    """uint8 ``(B, S, S, C)`` rotated about the centre → float32 ``(B, C, S, S)``
    in [0, 255], quantized to 1/256."""
    _, s, _, _ = images.shape
    q = torch.round(angle / 90.0)
    r = torch.deg2rad(angle - 90.0 * q)
    quarter = q.to(torch.int32) % 4
    a, b = -torch.tan(r / 2.0), torch.sin(r)
    pad = int(np.ceil(0.2072 * s)) + 2
    n = s + 2 * pad
    ka = int(np.ceil(0.41422 * (n - 1) / 2.0)) + 1
    kb = int(np.ceil(0.70711 * (n - 1) / 2.0)) + 1
    x = F.pad(images.permute(0, 3, 1, 2).to(torch.int32) * 256, (pad,) * 4)
    turns = torch.stack([torch.rot90(x, t, dims=(-2, -1)) for t in range(4)], dim=1)
    x = turns[torch.arange(x.shape[0], device=x.device), quarter.to(torch.int64)]
    x = _shear_x(x, a, ka)
    x = _shear_x(x.transpose(-2, -1), b, kb).transpose(-2, -1)
    x = _shear_x(x, a, ka)
    return x[..., pad:pad + s, pad:pad + s].to(torch.float32) * (1.0 / 256.0)


def _interp(n_out, n_in, scale, offset):
    j = torch.arange(n_out, dtype=torch.float32, device=scale.device)
    u = scale[:, None] * (j + 0.5) + offset[:, None] - 0.5
    x = torch.arange(n_in, dtype=torch.float32, device=scale.device)
    return torch.clamp(1.0 - torch.abs(u[:, :, None] - x), min=0.0)


def _jitter(image, factors, order):
    for step in range(3):
        op = order[:, step]
        f = torch.gather(factors, 1, op[:, None])[:, :, None, None]
        gray = (0.299 * image[:, 0] + 0.587 * image[:, 1] + 0.114 * image[:, 2])[:, None]
        mean = gray.mean(dim=(2, 3), keepdim=True)
        op = op[:, None, None, None]
        g = torch.where(op == 2, gray, torch.where(op == 1, mean, torch.zeros_like(mean)))
        image = torch.clamp(image * f + g * (1 - f), 0.0, 255.0)
    return image


def _band(n, k, r):
    d = torch.arange(n + 2 * r, device=k.device)[None, :] - torch.arange(n, device=k.device)[:, None]
    taps = k[:, torch.clamp(d, 0, 2 * r)]
    return torch.where((d >= 0) & (d <= 2 * r), taps, torch.zeros_like(taps))


def _blur(image, radius, r=2):
    sigma = torch.clamp(radius, min=1e-3)[:, None]
    offs = torch.arange(-r, r + 1, dtype=torch.float32, device=image.device)
    k = torch.exp(-(offs ** 2) / (2 * sigma ** 2))
    k = torch.where(radius[:, None] < 1e-2, (offs == 0).to(torch.float32), k)
    k = k / k.sum(dim=1, keepdim=True)
    _, _, h, w = image.shape
    padded = F.pad(image, (r,) * 4, mode="replicate")
    out = torch.matmul(_band(h, k, r)[:, None], padded)
    return torch.matmul(out, _band(w, k, r)[:, None].transpose(-1, -2))


def gaussians(mu, valid, size, reach, sigma=2.0):
    """Windowed Gaussians at integer peaks ``mu (B, K, 2)`` → ``(B, S, S, K)``;
    joints with ``valid`` 0 are all zero."""
    mu = mu.to(torch.int32)
    xs = torch.arange(size, dtype=torch.int32, device=mu.device)
    dx = xs[None, None, :, None] - mu[..., 0][:, None, None, :]
    dy = xs[None, :, None, None] - mu[..., 1][:, None, None, :]
    g = torch.exp(-(dx * dx + dy * dy).to(torch.float32) / (2.0 * sigma * sigma))
    keep = (dx.abs() <= reach) & (dy.abs() <= reach) & (valid[:, None, None, :] > 0)
    return torch.where(keep, g, torch.zeros((), device=mu.device))


def batch(store, gen, b, *, image_size, heatmap_size, rotation, scale_range, sigma=2.0):
    """One training batch ``{image, target, weight}`` of ``store`` (a dict
    of device tensors ``images, kps, vis``) drawn from ``gen``."""
    n, s = store["images"].shape[:2]
    idx, p = draw(gen, n, b, size=s, rotation=rotation, scale_range=scale_range)
    img = store["images"].index_select(0, idx)
    out = rotate(img, p["angle"])
    scale = p["side"] / image_size
    wy = _interp(image_size, s, scale, p["offset"][:, 1])
    wx = _interp(image_size, s, scale, p["offset"][:, 0])
    out = torch.matmul(torch.matmul(wy[:, None], out), wx[:, None].transpose(-1, -2))
    out = _blur(_jitter(out, p["factors"], p["order"]), p["radius"])
    mean = torch.tensor(MEAN, device=out.device)[:, None, None]
    std = torch.tensor(STD, device=out.device)[:, None, None]
    image = ((out / 255.0 - mean) / std).permute(0, 2, 3, 1).contiguous()

    rad = -torch.deg2rad(p["angle"])
    cos, sin = torch.cos(rad)[:, None], torch.sin(rad)[:, None]
    kp = store["kps"].index_select(0, idx)
    dx, dy = kp[..., 0] - s / 2.0, kp[..., 1] - s / 2.0
    kp = torch.stack([dx * cos + dy * -sin, dx * sin + dy * cos], dim=-1) + s / 2.0
    kp = (kp - p["offset"][:, None, :]) * (image_size / p["side"])[:, None, None]
    stride = image_size / heatmap_size
    mu = torch.trunc(kp / stride + 0.5).to(torch.int32)
    inside = ((mu >= 0) & (mu < heatmap_size)).all(dim=-1)
    weight = store["vis"].index_select(0, idx) * inside.to(torch.float32)
    target = gaussians(mu, weight > 0.5, heatmap_size, int(3 * sigma), sigma)
    return {"image": image, "target": target, "weight": weight}


def peaks(y):
    """First-maximum argmax peaks ``(B, K, 2)`` int32 ``(x, y)`` of
    ``(B, H, W, K)``; a maximum <= 0 goes to the origin."""
    b, h, w, k = y.shape
    flat = y.reshape(b, h * w, k)
    idx = flat.argmax(dim=1)
    keep = flat.amax(dim=1) > 0.0
    return torch.stack([torch.where(keep, idx % w, 0), torch.where(keep, idx // w, 0)],
                       dim=-1).to(torch.int32)
