"""Post-training int8 quantization of the serving path (w8a8 convs).

Port of ``dahpe_tpu/quant.py``: the standard PTQ recipe, on the port's state
dict and NHWC activations.

1. **Fold BatchNorm into the convs** (:func:`fold_serving_params`), in numpy,
   so the folded weights equal the JAX package's bit for bit after a layout
   transpose. Weights are kept in torch's ``(O, I, kh, kw)`` layout; a
   deconvolution becomes the equivalent lhs-dilated convolution (the
   ``ConvTranspose2d`` weight spatially flipped, in and out swapped), whose
   padding is :func:`_geom_deconv`'s ``(lo, hi)``. The folded tree drives a
   functional re-execution of the serving forward (:func:`_forward`) whose
   structure (strides, groups, deconv geometry, residuals) is read from the
   tree, so every backbone of ``models.BACKBONES`` works unchanged.
2. **Calibrate activation scales** (:func:`calibrate_act_scales`): one float
   pass records each conv input's absolute maximum, or a percentile of it.
3. **Quantize** (:func:`quantize_serving`, numpy): per-output-channel
   symmetric int8 weights, a per-tensor symmetric activation scale per conv.
4. **Serve** (:func:`apply_int8`, :func:`make_int8_predict_fn`): every conv
   is im2col of the int8 activations times the int8 weights through
   ``torch._int_mm`` with int32 accumulation, exact as the JAX package's
   ``preferred_element_type=int32`` convolution is; the glue (requantize,
   bias, ReLU, residual adds, max-pool) stays in float.

Trees are nested dicts and lists: ``{"stem", "layers": [[block]], "up":
[...], "head": [...]}``, each conv an entry ``{"w", "b"}`` (folded) or
``{"wq", "sw", "b", "sx"}`` (quantized). :func:`quantize_serving` returns
numpy leaves; :func:`to_torch` moves a tree onto a device for
:func:`apply_int8` and the exported artifact.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_BN_EPS = 1e-5  # models/batch_norm.py:BatchNorm2d.eps


def map_tree(fn, tree):
    """``fn`` applied to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def to_torch(tree, device=None):
    """A tree's leaves as tensors on ``device`` (numpy scalars become 0-dim
    tensors, which an exported program takes as inputs)."""
    return map_tree(lambda v: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                                              else v, device=device), tree)


# --------------------------------------------------------------------------
# 1. BN folding + structure extraction
# --------------------------------------------------------------------------

def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def _deconv_as_conv(w: np.ndarray) -> np.ndarray:
    """``ConvTranspose2d`` weight ``(I, O, kh, kw)`` → the weight ``(O, I, kh,
    kw)`` of the equivalent lhs-dilated convolution: in and out swapped,
    spatially flipped."""
    return np.ascontiguousarray(w.transpose(1, 0, 2, 3)[:, :, ::-1, ::-1])


def _fold(sd: dict, conv: str, bn: str, *, deconv: bool = False) -> dict:
    """conv → BN(eval) collapsed to conv+bias: ``w' = w·γ/√(σ²+ε)`` over the
    output channel, ``b' = β − μ·γ/√(σ²+ε)`` (+ the conv's own bias folded
    through the BN when present)."""
    w = _np(sd[conv + ".weight"])
    if deconv:
        w = _deconv_as_conv(w)
    r = _np(sd[bn + ".weight"]) / np.sqrt(_np(sd[bn + ".running_var"]) + _BN_EPS)
    b = _np(sd[bn + ".bias"]) - _np(sd[bn + ".running_mean"]) * r
    if conv + ".bias" in sd:
        b = b + _np(sd[conv + ".bias"]) * r
    return {"w": w * r[:, None, None, None], "b": b}


def _plain(sd: dict, conv: str) -> dict:
    w = _np(sd[conv + ".weight"])
    b = sd.get(conv + ".bias")
    return {"w": w, "b": _np(b) if b is not None else np.zeros(w.shape[0], np.float32)}


def fold_serving_params(state_dict) -> dict:
    """The serving forward's folded weights (numpy), from the port's state
    dict (or the model) of a ``PoseResNet`` or ``MultiHeadPoseResNet``: only
    the backbone, the upsampling and the main head are read, as the serving
    decode reads ``y``."""
    sd = state_dict.state_dict() if isinstance(state_dict, torch.nn.Module) else state_dict
    out = {"stem": _fold(sd, "backbone.conv1", "backbone.bn1")}
    layers: list[list[dict]] = []
    li = 1
    while f"backbone.layer{li}.0.conv1.weight" in sd:
        blocks = []
        bi = 0
        while f"backbone.layer{li}.{bi}.conv1.weight" in sd:
            p = f"backbone.layer{li}.{bi}."
            blk = {"conv1": _fold(sd, p + "conv1", p + "bn1"),
                   "conv2": _fold(sd, p + "conv2", p + "bn2")}
            if p + "conv3.weight" in sd:  # Bottleneck
                blk["conv3"] = _fold(sd, p + "conv3", p + "bn3")
            if p + "downsample.0.weight" in sd:
                blk["downsample"] = _fold(sd, p + "downsample.0", p + "downsample.1")
            blocks.append(blk)
            bi += 1
        layers.append(blocks)
        li += 1
    out["layers"] = layers

    up, i = [], 0
    while f"upsampling.{3 * i}.weight" in sd:
        up.append(_fold(sd, f"upsampling.{3 * i}", f"upsampling.{3 * i + 1}", deconv=True))
        i += 1
    out["up"] = up
    if "head.weight" in sd:  # PoseResNet: bare Conv1x1 head
        out["head"] = [_plain(sd, "head")]
    else:  # MultiHeadPoseResNet main PlainHead: [Conv3x3→BN→ReLU]* → Conv1x1
        n_stages = 0
        while f"head.{3 * n_stages + 1}.running_mean" in sd:
            n_stages += 1
        out["head"] = [_fold(sd, f"head.{3 * i}", f"head.{3 * i + 1}") for i in range(n_stages)]
        out["head"].append(_plain(sd, f"head.{3 * n_stages}"))
    return out


# --------------------------------------------------------------------------
# 2. The functional serving forward with a pluggable conv op
# --------------------------------------------------------------------------

def _geom_deconv(k: int) -> tuple[int, int]:
    """torch ConvTranspose (k, s=2) geometry as lhs-dilated conv padding —
    the models/upsampling.py kernel-size rule."""
    if k == 4:
        p, op = 1, 0
    elif k == 3:
        p, op = 1, 1
    elif k == 2:
        p, op = 0, 0
    else:
        raise NotImplementedError(f"kernel_size {k}")
    pad = k - 1 - p
    return pad, pad + op


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-2 max-pool with −inf padding 1 of NHWC ``x``."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def _forward(folded: dict, x: torch.Tensor, conv_op) -> torch.Tensor:
    """Replay the serving forward (backbone → upsampling → main head) from a
    folded tree on NHWC ``x``. ``conv_op(name, x, entry, *, stride, padding,
    lhs_dilation)`` implements the conv+bias; everything else (ReLU,
    max-pool, residual adds) is glue shared by all modes."""

    def conv(name, x, e, stride=1, padding=0, lhs_dilation=None):
        return conv_op(name, x, e, stride=stride, padding=padding, lhs_dilation=lhs_dilation)

    x = _max_pool(torch.relu(conv("stem", x, folded["stem"], stride=2, padding=3)))
    for li, blocks in enumerate(folded["layers"]):
        for bi, blk in enumerate(blocks):
            # stride is structural, never stored in the tree: the first block
            # of layer2..4 downsamples (models/resnet.py)
            stride = 2 if (li > 0 and bi == 0) else 1
            n = f"l{li + 1}b{bi}"
            idn = x
            if "conv3" in blk:  # Bottleneck 1-3-1
                y = torch.relu(conv(n + "c1", x, blk["conv1"]))
                y = torch.relu(conv(n + "c2", y, blk["conv2"], stride=stride, padding=1))
                y = conv(n + "c3", y, blk["conv3"])
            else:  # BasicBlock 3-3
                y = torch.relu(conv(n + "c1", x, blk["conv1"], stride=stride, padding=1))
                y = conv(n + "c2", y, blk["conv2"], padding=1)
            if "downsample" in blk:
                idn = conv(n + "ds", x, blk["downsample"], stride=stride)
            x = torch.relu(y + idn)
    for i, e in enumerate(folded["up"]):
        kernel = e["w"] if "w" in e else e["wq"]
        x = torch.relu(conv(f"up{i}", x, e, padding=_geom_deconv(kernel.shape[2]),
                            lhs_dilation=(2, 2)))
    for i, e in enumerate(folded["head"][:-1]):
        x = torch.relu(conv(f"head{i}", x, e, padding=1))
    return conv("head_out", x, folded["head"][-1])


def _pads(padding) -> tuple[int, int]:
    return (padding, padding) if isinstance(padding, int) else tuple(padding)


def _float_conv(x, w, b, *, stride, padding, lhs_dilation):
    """conv+bias of NHWC ``x`` with an ``(O, I, kh, kw)`` weight; an
    lhs-dilated conv runs as the transposed convolution it is."""
    lo, hi = _pads(padding)
    xc = x.permute(0, 3, 1, 2)
    groups = xc.shape[1] // w.shape[1]
    if lhs_dilation is None:  # symmetric padding: lo == hi
        y = F.conv2d(xc, w, b, stride=stride, padding=lo, groups=groups)
    else:
        if groups != 1:
            raise NotImplementedError("grouped lhs-dilated convolution")
        k = w.shape[2]
        y = F.conv_transpose2d(xc, w.flip(2, 3).transpose(0, 1), b, stride=lhs_dilation,
                               padding=k - 1 - lo, output_padding=hi - lo)
    return y.permute(0, 2, 3, 1)


def apply_folded(folded: dict, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Float reference execution of the folded tree (parity oracle and
    calibration backbone) on NHWC ``x``; the tree may hold numpy leaves."""
    tree = to_torch(folded, x.device)

    def conv_op(name, x, e, *, stride, padding, lhs_dilation):
        return _float_conv(x.to(dtype), e["w"].to(dtype), e["b"].to(dtype), stride=stride,
                           padding=padding, lhs_dilation=lhs_dilation)

    with torch.no_grad():
        return _forward(tree, x.to(dtype), conv_op)


# --------------------------------------------------------------------------
# 3. Calibration + quantization
# --------------------------------------------------------------------------

def sorted_percentile(a: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q``-th percentile of all of ``a`` by numpy's default linear
    interpolation (``jnp.percentile`` follows it), computed by a sort:
    ``torch.quantile`` refuses inputs above 2²⁴ elements, and a calibration
    batch of 32 frames at 256² gives a conv input of 33.5M."""
    s = torch.sort(a.reshape(-1).to(torch.float32)).values
    pos = (q / 100.0) * (s.numel() - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, s.numel() - 1)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


def calibrate_act_scales(folded: dict, images: torch.Tensor, *,
                         percentile: float | None = None) -> dict:
    """Per-conv-input activation ranges from one float pass over ``images``
    (normalized NHWC model inputs; the pass runs on their device).

    ``percentile=None`` records plain absolute maxima — exact, but a single
    outlier batch crushes the int8 resolution of every later input.
    ``percentile=99.9`` (say) records that percentile of |x| per conv input
    instead: the tail is clipped by the quantizer's ±127 clamp while the
    bulk keeps full 8-bit resolution (``dahpe_tpu/quant.py:238``). The
    pass runs in full float32 (no TF32 on the card)."""
    from dahpe_tpu_torch import set_float32_policy

    set_float32_policy()
    tree = to_torch(folded, images.device)
    maxes: dict[str, torch.Tensor] = {}

    def conv_op(name, x, e, *, stride, padding, lhs_dilation):
        a = torch.abs(x)
        maxes[name] = torch.amax(a) if percentile is None else sorted_percentile(a, percentile)
        return _float_conv(x, e["w"], e["b"], stride=stride, padding=padding,
                           lhs_dilation=lhs_dilation)

    with torch.no_grad():
        _forward(tree, images.to(torch.float32), conv_op)
    return {k: float(v) for k, v in maxes.items()}


def quantize_serving(folded: dict, act_scales: dict) -> dict:
    """int8 deployment tree (numpy): per-output-channel symmetric weights, the
    calibrated per-tensor activation scale riding along with each conv."""

    def q(e, name):
        w = np.asarray(e["w"], np.float32)
        sw = np.maximum(np.abs(w).max(axis=(1, 2, 3)), 1e-12) / 127.0
        wq = np.clip(np.round(w / sw[:, None, None, None]), -127, 127).astype(np.int8)
        sx = np.float32(max(act_scales[name], 1e-12) / 127.0)
        return {"wq": wq, "sw": sw.astype(np.float32), "b": np.asarray(e["b"], np.float32),
                "sx": sx}

    out = {"stem": q(folded["stem"], "stem"), "layers": [], "up": [], "head": []}
    for li, blocks in enumerate(folded["layers"]):
        qblocks = []
        for bi, blk in enumerate(blocks):
            n = f"l{li + 1}b{bi}"
            qb = {"conv1": q(blk["conv1"], n + "c1"), "conv2": q(blk["conv2"], n + "c2")}
            if "conv3" in blk:
                qb["conv3"] = q(blk["conv3"], n + "c3")
            if "downsample" in blk:
                qb["downsample"] = q(blk["downsample"], n + "ds")
            qblocks.append(qb)
        out["layers"].append(qblocks)
    out["up"] = [q(e, f"up{i}") for i, e in enumerate(folded["up"])]
    out["head"] = [q(e, f"head{i}") for i, e in enumerate(folded["head"][:-1])]
    out["head"].append(q(folded["head"][-1], "head_out"))
    return out


def _dilate(x: torch.Tensor, d: tuple[int, int]) -> torch.Tensor:
    """NHWC ``x`` with ``d - 1`` zeros between neighbouring pixels."""
    b, h, w, c = x.shape
    out = x.new_zeros((b, (h - 1) * d[0] + 1, (w - 1) * d[1] + 1, c))
    out[:, ::d[0], ::d[1]] = x
    return out


def _int_mm(a: torch.Tensor, w: torch.Tensor, min_rows: bool) -> torch.Tensor:
    """``a (M, K) @ w (N, K)ᵀ`` in int32 through ``torch._int_mm``, zero-padded
    to its CUDA shapes (K and N multiples of 8, M above 16; ``min_rows``
    says M may not be, a static fact where M is a symbolic batch times the
    rows of a frame): zeros add nothing, so the product stays exact. The
    weight goes in as the transpose of its row-major matrix, the layout
    cuBLASLt's int8 kernels run fastest."""
    m, k = a.shape
    n = w.shape[0]
    pk, pn = -k % 8, -n % 8
    if pk:
        a, w = F.pad(a, (0, pk)), F.pad(w, (0, pk))
    if pn:
        w = F.pad(w, (0, 0, 0, pn))
    if min_rows:
        a = F.pad(a, (0, 0, 0, 16))
    y = torch._int_mm(a, w.t())
    return y[:m, :n] if (pn or min_rows) else y


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, *, stride: int = 1, padding=0,
              lhs_dilation=None) -> torch.Tensor:
    """int8×int8→int32 convolution of NHWC ``xq`` with an ``(O, I, kh, kw)``
    weight (``groups = C / I``): im2col of the activations (a view for 1×1
    convs), then one ``torch._int_mm`` per group. Exact; its plain version
    is :func:`int8_conv_plain`."""
    lo, hi = _pads(padding)
    if lhs_dilation is not None:
        xq, stride = _dilate(xq, lhs_dilation), 1
    if lo or hi:
        xq = F.pad(xq, (0, 0, lo, hi, lo, hi))
    o, i, kh, kw = wq.shape
    b, h, w, c = xq.shape
    groups = c // i
    ho, wo = (h - kh) // stride + 1, (w - kw) // stride + 1
    if kh == kw == 1:
        cols = xq[:, ::stride, ::stride, :] if stride > 1 else xq  # (B, Ho, Wo, C)
    else:
        cols = xq.unfold(1, kh, stride).unfold(2, kw, stride)  # (B, Ho, Wo, C, kh, kw)
    og, depth = o // groups, i * kh * kw
    outs = [
        _int_mm(cols[:, :, :, g * i:(g + 1) * i].reshape(b * ho * wo, depth),
                wq[g * og:(g + 1) * og].reshape(og, depth), ho * wo <= 16)
        for g in range(groups)
    ]
    y = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return y.reshape(b, ho, wo, o)


def int8_conv_plain(xq: torch.Tensor, wq: torch.Tensor, *, stride: int = 1, padding=0,
                    lhs_dilation=None) -> torch.Tensor:
    """:func:`int8_conv` as a float64 convolution of the same integer values:
    every partial sum is an integer below 2⁵³, so it is exact, then cast to
    int32."""
    lo, hi = _pads(padding)
    x = xq.to(torch.float64)
    if lhs_dilation is not None:
        x, stride = _dilate(x, lhs_dilation), 1
    x = F.pad(x, (0, 0, lo, hi, lo, hi)).permute(0, 3, 1, 2)
    y = F.conv2d(x, wq.to(torch.float64), stride=stride, groups=x.shape[1] // wq.shape[1])
    return y.permute(0, 2, 3, 1).to(torch.int32)


def apply_int8(quantized: dict, x: torch.Tensor, glue=torch.bfloat16) -> torch.Tensor:
    """The quantized serving forward on NHWC ``x``; ``quantized`` holds
    tensors on ``x``'s device (:func:`to_torch`).

    ``glue`` is the dtype activations are stored in between convs (ReLU
    outputs, residual adds, max-pool). Each conv's quantize math (divide,
    round half to even, clip) runs in float32 whatever the glue, as its
    dequantize does; the heatmaps come back in float32."""

    def conv_op(name, x, e, *, stride, padding, lhs_dilation):
        xq = torch.clamp(torch.round(x.to(torch.float32) / e["sx"]), -127, 127).to(torch.int8)
        yq = int8_conv(xq, e["wq"], stride=stride, padding=padding, lhs_dilation=lhs_dilation)
        scale = e["sw"].to(torch.float32) * e["sx"]
        y = yq.to(torch.float32) * scale + e["b"].to(torch.float32)
        return y.to(glue)

    return _forward(quantized, x.to(glue), conv_op).to(torch.float32)


# --------------------------------------------------------------------------
# 4. Serving entry (evaluate.make_predict_fn contract)
# --------------------------------------------------------------------------

def make_int8_predict_fn(*, image_size: int = 256, heatmap_size: int = 64,
                         uint8_input: bool = False, glue=torch.bfloat16, device=None):
    """Quantized serving entry: ``predict(quantized, images) -> (coords (B, K,
    2), maxvals (B, K, 1))``, coordinates in image pixels — the int8 twin of
    ``evaluate.make_predict_fn`` (same decode, same uint8-ingest option), on
    ``device`` (default ``cuda``), where ``quantized`` (:func:`to_torch`)
    and the images must lie. It is the module that
    ``serving.export_predict_int8`` exports."""
    from dahpe_tpu_torch.evaluate import PredictProgram

    return PredictProgram(lambda quantized, x: apply_int8(quantized, x, glue=glue),
                          image_size=image_size, heatmap_size=heatmap_size,
                          uint8_input=uint8_input, device=device)


def quantize_model(model, calib_images: torch.Tensor, *,
                   percentile: float | None = None) -> dict:
    """One-call PTQ: fold ``model``'s weights, calibrate on ``calib_images``
    (normalized NHWC inputs, on the device the pass should run on),
    quantize. Returns the numpy deployment tree for :func:`to_torch` and
    :func:`apply_int8`. ``percentile`` selects the outlier-clipping
    calibration (:func:`calibrate_act_scales`)."""
    folded = fold_serving_params(model)
    scales = calibrate_act_scales(folded, calib_images, percentile=percentile)
    return quantize_serving(folded, scales)
