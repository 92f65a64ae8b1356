"""SSD / Faster-RCNN detection-head operators: counterpart of
``paddle_tpu/vision/detection.py``.

``prior_box`` and ``anchor_generator`` are index math on the feature map's
shape, computed on its device in float32 with the JAX op's order of
operations; ``box_coder`` is elementwise; ``multiclass_nms`` is host-side
numpy post-processing, the JAX op's arithmetic (its IoU taken among each
class's candidates only, entry for entry the JAX matrix's), so it keeps
the padded contract (``[N, keep_top_k, 6]`` rows of ``(label, score, x1,
y1, x2, y2)`` padded with -1, plus the valid counts ``[N]``) and the same
order of results; its outputs land on the boxes' device.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from .ops import _t

__all__ = ["prior_box", "anchor_generator", "box_coder", "multiclass_nms"]


def _expand_aspect_ratios(aspect_ratios, flip: bool) -> List[float]:
    """1.0 first, duplicates (within 1e-6) dropped, reciprocals with
    ``flip``."""
    out = [1.0]
    for ar in aspect_ratios:
        if any(abs(ar - v) < 1e-6 for v in out):
            continue
        out.append(float(ar))
        if flip:
            out.append(1.0 / float(ar))
    return out


def _device(x):
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _corners(cx, cy, hw, hh, div_w, div_h):
    """[H, W, P, 4] boxes ``((cx - hw) / div_w, (cy - hh) / div_h, (cx + hw)
    / div_w, (cy + hh) / div_h)``."""
    x1 = (cx[None, :, None] - hw[None, None, :]) / div_w
    y1 = (cy[:, None, None] - hh[None, None, :]) / div_h
    x2 = (cx[None, :, None] + hw[None, None, :]) / div_w
    y2 = (cy[:, None, None] + hh[None, None, :]) / div_h
    return torch.stack(torch.broadcast_tensors(x1, y1, x2, y2), dim=-1)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    """SSD prior boxes over a feature map -> ``(boxes, variances)``, each
    ``[H, W, num_priors, 4]``, normalised to the image."""
    min_sizes = [float(m) for m in (min_sizes if isinstance(
        min_sizes, (list, tuple)) else [min_sizes])]
    max_sizes = [float(m) for m in (max_sizes or [])]
    if max_sizes and len(max_sizes) != len(min_sizes):
        raise ValueError("max_sizes must pair 1:1 with min_sizes")
    ars = _expand_aspect_ratios(
        aspect_ratios if isinstance(aspect_ratios, (list, tuple))
        else [aspect_ratios], flip)
    dev = _device(input)
    fh, fw = int(input.shape[2]), int(input.shape[3])
    ih, iw = int(image.shape[2]), int(image.shape[3])
    step_w = float(steps[0]) or iw / fw
    step_h = float(steps[1]) or ih / fh
    # per-position half-sizes in generation order: a min size's aspect
    # ratios then its max, or (Caffe) min, max, the ratios other than 1
    half_sizes = []
    for s, mn in enumerate(min_sizes):
        if min_max_aspect_ratios_order:
            half_sizes.append((mn / 2.0, mn / 2.0))
            if max_sizes:
                m = math.sqrt(mn * max_sizes[s]) / 2.0
                half_sizes.append((m, m))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                half_sizes.append((mn * math.sqrt(ar) / 2.0,
                                   mn / math.sqrt(ar) / 2.0))
        else:
            for ar in ars:
                half_sizes.append((mn * math.sqrt(ar) / 2.0,
                                   mn / math.sqrt(ar) / 2.0))
            if max_sizes:
                m = math.sqrt(mn * max_sizes[s]) / 2.0
                half_sizes.append((m, m))
    f32 = torch.float32
    hw = torch.tensor([p[0] for p in half_sizes], dtype=f32, device=dev)
    hh = torch.tensor([p[1] for p in half_sizes], dtype=f32, device=dev)
    cx = (torch.arange(fw, dtype=f32, device=dev) + offset) * step_w
    cy = (torch.arange(fh, dtype=f32, device=dev) + offset) * step_h
    boxes = _corners(cx, cy, hw, hh, iw, ih)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    var = torch.tensor(variance, dtype=f32, device=dev).expand(boxes.shape)
    return boxes, var


def anchor_generator(input, anchor_sizes, aspect_ratios,
                     variances=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset=0.5, name=None):
    """RPN anchors -> ``(anchors, variances)``, each ``[H, W,
    num_anchors, 4]``, in absolute pixel coordinates."""
    dev = _device(input)
    fh, fw = int(input.shape[2]), int(input.shape[3])
    sw, sh = float(stride[0]), float(stride[1])
    whs = []
    for ar in aspect_ratios:
        for size in anchor_sizes:
            base_w = round(math.sqrt(sw * sh / ar))
            base_h = round(base_w * ar)
            whs.append((size / sw * base_w, size / sh * base_h))
    f32 = torch.float32
    aw = torch.tensor([w for w, _ in whs], dtype=f32, device=dev)
    ah = torch.tensor([h for _, h in whs], dtype=f32, device=dev)
    xc = torch.arange(fw, dtype=f32, device=dev) * sw + offset * (sw - 1)
    yc = torch.arange(fh, dtype=f32, device=dev) * sh + offset * (sh - 1)
    anchors = _corners(xc, yc, 0.5 * (aw - 1), 0.5 * (ah - 1), 1.0, 1.0)
    var = torch.tensor(variances, dtype=f32, device=dev) \
        .expand(anchors.shape)
    return anchors, var


def box_coder(prior_box, prior_box_var, target_box,
              code_type: str = "encode_center_size",
              box_normalized: bool = True, axis: int = 0, name=None):
    """Encode / decode boxes against priors with variances.

    encode: target [N, 4], prior [M, 4] -> [N, M, 4];
    decode: target [N, M, 4], the prior along M (``axis=0``) or N
    (``axis=1``) -> [N, M, 4]."""
    tb = _t(target_box).float()
    pb = _t(prior_box, tb).float().to(tb.device)
    if prior_box_var is None:
        pbv = None
    elif isinstance(prior_box_var, (list, tuple)):
        pbv = torch.tensor(prior_box_var, dtype=torch.float32,
                           device=tb.device)                  # [4]
    else:
        pbv = _t(prior_box_var, tb).float().to(tb.device)      # [M, 4]
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw / 2
    pcy = pb[:, 1] + ph / 2
    if code_type.lower() in ("encode_center_size", "encode"):
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = (tb[:, 0] + tb[:, 2]) / 2
        tcy = (tb[:, 1] + tb[:, 3]) / 2
        out = torch.stack([
            (tcx[:, None] - pcx[None, :]) / pw[None, :],
            (tcy[:, None] - pcy[None, :]) / ph[None, :],
            torch.log(torch.abs(tw[:, None] / pw[None, :])),
            torch.log(torch.abs(th[:, None] / ph[None, :])),
        ], dim=-1)
        if pbv is not None:
            out = out / (pbv if pbv.dim() == 1 else pbv[None, :, :])
        return out
    if tb.dim() != 3:
        raise ValueError("decode_center_size expects target [N, M, 4]")

    def ex(a):
        return a[None, :] if axis == 0 else a[:, None]

    d = tb
    if pbv is not None:
        d = d * (pbv if pbv.dim() == 1 else ex(pbv))
    cx = d[..., 0] * ex(pw) + ex(pcx)
    cy = d[..., 1] * ex(ph) + ex(pcy)
    w = torch.exp(d[..., 2]) * ex(pw)
    h = torch.exp(d[..., 3]) * ex(ph)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2 - norm,
                        cy + h / 2 - norm], dim=-1)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold: float = 0.3, normalized: bool = True,
                   nms_eta: float = 1.0, background_label: int = 0,
                   name=None):
    """Per-class NMS and the cross-class top ``keep_top_k``: bboxes [N, M,
    4], scores [N, C, M] -> ``(out [N, keep_top_k, 6] as (label, score,
    x1, y1, x2, y2) padded with -1, counts [N] int32)``."""
    bb = _host(bboxes)
    sc = _host(scores)
    N, C, M = sc.shape
    K = int(keep_top_k) if keep_top_k > 0 else M * C
    out = np.full((N, K, 6), -1.0, np.float32)
    counts = np.zeros((N,), np.int32)

    def _iou_matrix(b):
        # +1 to w/h for unnormalized pixel boxes
        off = 0.0 if normalized else 1.0
        area = (b[:, 2] - b[:, 0] + off) * (b[:, 3] - b[:, 1] + off)
        lt = np.maximum(b[:, None, :2], b[None, :, :2])
        rb = np.minimum(b[:, None, 2:], b[None, :, 2:])
        wh = np.clip(rb - lt + off, 0, None)
        inter = wh[..., 0] * wh[..., 1]
        return inter / (area[:, None] + area[None, :] - inter + 1e-10)

    for n in range(N):
        dets = []                      # (score, label, box)
        for c in range(C):
            if c == background_label:
                continue
            s = sc[n, c]
            idx = np.nonzero(s > score_threshold)[0]
            if idx.size == 0:
                continue
            order = idx[np.argsort(-s[idx], kind="stable")]
            if nms_top_k > -1:
                order = order[:nms_top_k]
            # the IoU among this class's candidates only: each entry is
            # the JAX op's full-matrix entry, the same elementwise sums
            iou = _iou_matrix(bb[n, order])
            kept: List[int] = []
            thr = float(nms_threshold)
            for p in range(len(order)):
                if kept and bool((iou[p, kept] > thr).any()):
                    continue
                kept.append(p)
                if nms_eta < 1.0 and thr > 0.5:
                    thr *= nms_eta
            dets.extend((float(s[order[p]]), c, bb[n, order[p]])
                        for p in kept)
        dets.sort(key=lambda d: -d[0])
        dets = dets[:K]
        counts[n] = len(dets)
        for k, (sv, c, box) in enumerate(dets):
            out[n, k, 0] = c
            out[n, k, 1] = sv
            out[n, k, 2:] = box
    dev = _device(bboxes)
    return (torch.as_tensor(out, device=dev),
            torch.as_tensor(counts, device=dev))
