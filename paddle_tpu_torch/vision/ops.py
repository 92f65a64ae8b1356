"""Vision and detection operators: counterpart of
``paddle_tpu/vision/ops.py``.

The JAX module computes these ops in ``jnp`` (gathers, ``fori_loop``),
never through a Pallas kernel, so here they are PyTorch ops on the
inputs' device, differentiable where the JAX ones are (``roi_align``,
``roi_pool``, ``psroi_pool`` and ``deform_conv2d`` through the gathers,
with respect to the features, the offsets, the mask and the weights).
Numpy inputs become CPU tensors. Each op keeps the JAX op's arithmetic:

- ``box_iou``: ``inter / (area_a + area_b - inter + 1e-10)``.
- ``nms``: the boxes sorted by score (stable), the IoU matrix and the
  "later and above the threshold, same category" mask computed on the
  device in one pass, then the greedy keep on the host over that mask
  (one copy; the JAX ``fori_loop``'s N dependent steps would be N small
  launches on the card): the same kept indices, in score order.
- ``roi_align``: bilinear samples on the JAX grid (clipped to the map,
  ``sampling_ratio`` 2 when not given), averaged. The JAX op gathers
  every sample of a bin at once (``[R, C, ph, sr, pw, sr]`` a corner);
  this one gathers ``[R, C, ph, pw]`` a sample and sums the samples as
  it goes, so its results equal the JAX op's to f32 reassociation.
- ``roi_pool``: the JAX sparse-table range max (power-of-two window maxima
  a level, two gathers a bin), the same ops in the same order, so ties
  split their gradient alike.
- ``psroi_pool``: each output channel's bin gathers only its own input
  channel (``k * ph * pw + i * pw + j``) at the 4 x 4 nearest samples and
  averages them; the JAX op gathers every channel and then picks.
- ``yolo_box``, ``deform_conv2d``: the JAX formulas (an im2col of
  bilinear taps with out-of-map taps zero, then one grouped contraction).
- ``read_file`` / ``decode_jpeg``: host bytes and a PIL decode (PIL is
  imported inside the call), uint8 CPU tensors.

The detection-head ops of ``vision.detection`` and
``vision.detection_extra`` are re-exported here, as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["box_iou", "nms", "roi_align", "roi_pool", "yolo_box",
           "psroi_pool", "deform_conv2d", "read_file", "decode_jpeg"]


def _t(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` as a tensor (a numpy array on ``like``'s device, else the
    CPU)."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if like is not None else None
    return torch.as_tensor(np.asarray(x), device=dev)


def _roi_batch_index(boxes_num, n_rois: int, device) -> torch.Tensor:
    """boxes_num [N] -> each RoI's batch index [n_rois]."""
    bn = _t(boxes_num).to(device=device, dtype=torch.int64)
    return torch.repeat_interleave(torch.arange(bn.shape[0], device=device),
                                   bn, output_size=n_rois)


def _bin_sample_grid(start, bin_size, n_bins: int, sr: int):
    """Per-RoI sampling coordinates [R, n_bins, sr] along one axis:
    ``start + (bin + (s + 0.5) / sr) * bin_size``."""
    dev, dt = start.device, start.dtype
    offs = (torch.arange(sr, device=dev, dtype=dt) + 0.5) / sr
    grid = torch.arange(n_bins, device=dev, dtype=dt)[None, :, None] \
        + offs[None, None, :]
    return start[:, None, None] + grid * bin_size[:, None, None]


def _iou(a, b):
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-10)


def box_iou(boxes1, boxes2, name=None):
    """Pairwise IoU of [N, 4] and [M, 4] xyxy boxes -> [N, M]."""
    a = _t(boxes1)
    return _iou(a, _t(boxes2, a))


def nms(boxes, iou_threshold: float = 0.3, scores=None,
        category_idxs=None, categories=None, top_k: Optional[int] = None,
        name=None):
    """Greedy non-maximum suppression: the kept indices (int64, on the
    boxes' device) in score order (input order without scores); with
    ``category_idxs`` a box suppresses only boxes of its own category."""
    b = _t(boxes)
    n = b.shape[0]
    if scores is not None:
        order = torch.argsort(-_t(scores, b), stable=True)
    else:
        order = torch.arange(n, device=b.device)
    bs = b[order]
    sup = _iou(bs, bs) > iou_threshold
    if category_idxs is not None:
        cats = _t(category_idxs, b).to(b.device)[order]
        sup &= cats[:, None] == cats[None, :]
    sup = torch.triu(sup, diagonal=1).cpu().numpy()
    keep = np.ones(n, bool)
    for i in range(n):
        if keep[i]:
            keep &= ~sup[i]
    idx = order[torch.as_tensor(np.nonzero(keep)[0], device=b.device)]
    if top_k is not None:
        idx = idx[:top_k]
    return idx


def roi_align(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0,
              sampling_ratio: int = -1, aligned: bool = True, name=None):
    """RoIAlign -> [R, C, ph, pw]: ``sr x sr`` bilinear samples a bin
    (``sr = sampling_ratio``, 2 when not positive), averaged."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    sr = sampling_ratio if sampling_ratio > 0 else 2
    feat = _t(x)
    rois = _t(boxes, feat).to(feat.dtype)
    N, C, H, W = feat.shape
    off = 0.5 if aligned else 0.0
    x1 = rois[:, 0] * spatial_scale - off
    y1 = rois[:, 1] * spatial_scale - off
    x2 = rois[:, 2] * spatial_scale - off
    y2 = rois[:, 3] * spatial_scale - off
    rw = torch.clamp(x2 - x1, min=1e-3 if aligned else 1.0)
    rh = torch.clamp(y2 - y1, min=1e-3 if aligned else 1.0)
    ys = _bin_sample_grid(y1, rh / ph, ph, sr)               # [R, ph, sr]
    xs = _bin_sample_grid(x1, rw / pw, pw, sr)               # [R, pw, sr]
    bi = _roi_batch_index(boxes_num, rois.shape[0], feat.device)[:, None,
                                                                 None]
    out = None
    for iy in range(sr):
        y = ys[:, :, iy].clamp(0, H - 1)                     # [R, ph]
        y0 = torch.floor(y).long()
        y1i = torch.clamp(y0 + 1, max=H - 1)
        wy = (y - y0)[:, :, None]
        for ix in range(sr):
            xc = xs[:, :, ix].clamp(0, W - 1)                # [R, pw]
            x0 = torch.floor(xc).long()
            x1i = torch.clamp(x0 + 1, max=W - 1)
            wx = (xc - x0)[:, None, :]

            def g(yi, xi):                                   # [R, ph, pw, C]
                return feat[bi, :, yi[:, :, None], xi[:, None, :]]

            val = (g(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
                   + g(y0, x1i) * ((1 - wy) * wx)[..., None]
                   + g(y1i, x0) * (wy * (1 - wx))[..., None]
                   + g(y1i, x1i) * (wy * wx)[..., None])
            out = val if out is None else out + val
    return (out / (sr * sr)).permute(0, 3, 1, 2)


def _round_c(v):
    """C ``round()``: half away from zero."""
    return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0,
             name=None):
    """RoIPool -> [R, C, ph, pw]: the exact max over every integer
    position of each adaptive bin (rounded unclipped RoI corners, bins
    clipped to the map, an empty bin 0), by the JAX op's sparse-table
    range max over columns, then over rows."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    feat = _t(x)
    rois = _t(boxes, feat).to(feat.dtype)
    dev = feat.device
    N, C, H, W = feat.shape
    x1 = _round_c(rois[:, 0] * spatial_scale).long()
    y1 = _round_c(rois[:, 1] * spatial_scale).long()
    x2 = _round_c(rois[:, 2] * spatial_scale).long()
    y2 = _round_c(rois[:, 3] * spatial_scale).long()
    rw = torch.clamp(x2 - x1 + 1, min=1)
    rh = torch.clamp(y2 - y1 + 1, min=1)

    def bin_edges(start, rsz, nb, size):
        i = torch.arange(nb, device=dev)
        bs = torch.div(i[None, :] * rsz[:, None], nb,
                       rounding_mode="floor") + start[:, None]
        be = -torch.div(-(i[None, :] + 1) * rsz[:, None], nb,
                        rounding_mode="floor") + start[:, None]
        return bs.clamp(0, size), be.clamp(0, size)

    hs, he = bin_edges(y1, rh, ph, H)                    # [R, ph]
    ws, we = bin_edges(x1, rw, pw, W)                    # [R, pw]
    R = rois.shape[0]
    batch_idx = _roi_batch_index(boxes_num, R, dev)

    def qlevel(s, e, size):
        ln = torch.clamp(e - s, min=1)
        lvl = torch.zeros_like(ln)
        k = 1
        while (1 << k) <= size:
            lvl = lvl + (ln >= (1 << k)).long()
            k += 1
        return lvl, torch.ones_like(lvl) << lvl

    def shift_max(cur, p):
        pad = torch.full(cur.shape[:-1] + (p,), -math.inf, dtype=cur.dtype,
                         device=dev)
        return torch.maximum(cur, torch.cat([cur[..., p:], pad], dim=-1))

    # stage 1: colmax[r, j, c, h] = max(feat[b_r, c, h, ws_rj:we_rj])
    lvl_x, pow_x = qlevel(ws, we, W)
    sx = ws.clamp(0, W - 1)
    ex = (we - pow_x).clamp(0, W - 1)
    colmax = torch.full((R, pw, C, H), -math.inf, dtype=feat.dtype,
                        device=dev)
    cur = feat
    bi = batch_idx[:, None]
    for lv in range(max(1, int(math.floor(math.log2(W))) + 1)):
        v = torch.maximum(cur[bi, :, :, sx], cur[bi, :, :, ex])
        colmax = torch.where((lvl_x == lv)[:, :, None, None], v, colmax)
        cur = shift_max(cur, 1 << lv)
    # stage 2: the row range max over colmax's h axis
    lvl_y, pow_y = qlevel(hs, he, H)
    sy = hs.clamp(0, H - 1)
    ey = (he - pow_y).clamp(0, H - 1)
    ridx = torch.arange(R, device=dev)[:, None]
    out = torch.full((R, ph, pw, C), -math.inf, dtype=feat.dtype,
                     device=dev)
    cur = colmax
    for lv in range(max(1, int(math.floor(math.log2(H))) + 1)):
        v = torch.maximum(cur[ridx, :, :, sy], cur[ridx, :, :, ey])
        out = torch.where((lvl_y == lv)[:, :, None, None], v, out)
        cur = shift_max(cur, 1 << lv)
    out = out.permute(0, 3, 1, 2)
    empty = (he <= hs)[:, :, None] | (we <= ws)[:, None, :]
    return torch.where(empty[:, None], torch.zeros((), dtype=out.dtype,
                                                   device=dev), out)


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox: bool = True, name=None,
             scale_x_y: float = 1.0, iou_aware: bool = False,
             iou_aware_factor: float = 0.5):
    """Decode a YOLOv3 head ``x [N, A*(5+cls), H, W]`` into ``(boxes [N,
    A*H*W, 4], scores [N, A*H*W, cls])`` in image pixels, both zero where
    the objectness is under ``conf_thresh``."""
    if iou_aware:
        raise NotImplementedError(
            "yolo_box: iou_aware heads (extra A iou channels, conf = "
            "conf^(1-f) * iou^f) are not implemented")
    xa = _t(x)
    imgs = _t(img_size, xa).to(xa.device)
    anchors = np.asarray(anchors, np.float32).reshape(-1, 2)
    A = anchors.shape[0]
    N, _, H, W = xa.shape
    dev = xa.device
    pred = xa.reshape(N, A, 5 + class_num, H, W)
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None]
    gy = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :,
                                                          None]
    sig = torch.sigmoid
    bx = (sig(pred[:, :, 0]) * scale_x_y - 0.5 * (scale_x_y - 1.0) + gx) / W
    by = (sig(pred[:, :, 1]) * scale_x_y - 0.5 * (scale_x_y - 1.0) + gy) / H
    aw = torch.as_tensor(anchors[:, 0], device=dev)[None, :, None, None]
    ah = torch.as_tensor(anchors[:, 1], device=dev)[None, :, None, None]
    bw = torch.exp(pred[:, :, 2]) * aw / (W * downsample_ratio)
    bh = torch.exp(pred[:, :, 3]) * ah / (H * downsample_ratio)
    conf = sig(pred[:, :, 4])
    probs = sig(pred[:, :, 5:]) * conf[:, :, None]
    im_h = imgs[:, 0].float()[:, None, None, None]
    im_w = imgs[:, 1].float()[:, None, None, None]
    x1 = (bx - bw / 2) * im_w
    y1 = (by - bh / 2) * im_h
    x2 = (bx + bw / 2) * im_w
    y2 = (by + bh / 2) * im_h
    if clip_bbox:
        x1 = torch.clamp(torch.clamp(x1, min=0), max=im_w - 1)
        y1 = torch.clamp(torch.clamp(y1, min=0), max=im_h - 1)
        x2 = torch.clamp(torch.clamp(x2, min=0), max=im_w - 1)
        y2 = torch.clamp(torch.clamp(y2, min=0), max=im_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(N, A * H * W, 4)
    scores = probs.permute(0, 1, 3, 4, 2).reshape(N, A * H * W, class_num)
    mask = (conf.reshape(N, A * H * W) >= conf_thresh)[..., None]
    return boxes * mask, scores * mask


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0,
               name=None):
    """Position-sensitive RoI pooling -> [R, C / (ph * pw), ph, pw]: bin
    (i, j) of output channel k averages input channel ``k * ph * pw + i *
    pw + j`` at the bin's 4 x 4 nearest samples."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    feat = _t(x)
    rois = _t(boxes, feat).to(feat.dtype)
    dev = feat.device
    N, C, H, W = feat.shape
    if C % (ph * pw):
        raise ValueError(
            f"psroi_pool needs output_size {ph}x{pw} to divide the channel "
            f"count, got C={C}")
    out_c = C // (ph * pw)
    x1 = rois[:, 0] * spatial_scale
    y1 = rois[:, 1] * spatial_scale
    x2 = rois[:, 2] * spatial_scale
    y2 = rois[:, 3] * spatial_scale
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    sr = 4
    yi = _bin_sample_grid(y1, rh / ph, ph, sr).clamp(0, H - 1).long()
    xi = _bin_sample_grid(x1, rw / pw, pw, sr).clamp(0, W - 1).long()
    bi = _roi_batch_index(boxes_num, rois.shape[0], dev)
    chan = (torch.arange(out_c, device=dev)[:, None, None] * (ph * pw)
            + torch.arange(ph, device=dev)[None, :, None] * pw
            + torch.arange(pw, device=dev)[None, None, :])
    # [R, out_c, ph, sr, pw, sr]
    vals = feat[bi[:, None, None, None, None, None],
                chan[None, :, :, None, :, None],
                yi[:, None, :, :, None, None],
                xi[:, None, None, None, :, :]]
    return vals.mean(dim=(3, 5))


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups: int = 1, groups: int = 1,
                  mask=None, name=None):
    """Deformable convolution v1 (v2 with ``mask``): every kernel tap of
    every output position displaced by its learned offset ``[N, dg * 2 *
    K, oH, oW]`` (y then x a tap) and sampled bilinearly (taps off the map
    read 0), modulated by ``mask [N, dg * K, oH, oW]``, then contracted
    with ``weight [out, C / groups, kh, kw]``."""
    def _pair(v):
        return (v, v) if isinstance(v, int) else tuple(v)

    sh, sw = _pair(stride)
    padh, padw = _pair(padding)
    dh, dw = _pair(dilation)
    xa = _t(x)
    off = _t(offset, xa)
    w = _t(weight, xa)
    dev = xa.device
    N, C, H, W = xa.shape
    out_c, c_per_g, kh, kw = w.shape
    K = kh * kw
    oH = (H + 2 * padh - (dh * (kh - 1) + 1)) // sh + 1
    oW = (W + 2 * padw - (dw * (kw - 1) + 1)) // sw + 1
    dg = deformable_groups
    c_per_dg = C // dg
    f32 = torch.float32
    base_y = (torch.arange(oH, device=dev)[None, :, None] * sh - padh
              + (torch.arange(kh, device=dev)[:, None, None] * dh)
              .repeat_interleave(kw, dim=0))
    base_x = (torch.arange(oW, device=dev)[None, None, :] * sw - padw
              + torch.arange(kw, device=dev).repeat(kh)[:, None, None] * dw)
    base_y = base_y.expand(K, oH, oW).to(f32)
    base_x = base_x.expand(K, oH, oW).to(f32)
    off = off.reshape(N, dg, 2 * K, oH, oW)
    y = (base_y[None, None] + off[:, :, 0::2]).clamp(-1.0, H + 0.0)
    xc = (base_x[None, None] + off[:, :, 1::2]).clamp(-1.0, W + 0.0)
    y0 = torch.floor(y)
    x0 = torch.floor(xc)
    wy = y - y0
    wx = xc - x0
    imgs = xa.reshape(N, dg, c_per_dg, H, W)
    ni = torch.arange(N, device=dev)[:, None, None, None, None]
    gi = torch.arange(dg, device=dev)[None, :, None, None, None]

    def at(yi, xi):                          # [N, dg, c, K, oH, oW]
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yl = yi.clamp(0, H - 1).long()
        xl = xi.clamp(0, W - 1).long()
        v = imgs[ni, gi, :, yl, xl]          # [N, dg, K, oH, oW, c]
        return (v * inb[..., None]).permute(0, 1, 5, 2, 3, 4)

    cols = (at(y0, x0) * ((1 - wy) * (1 - wx))[:, :, None]
            + at(y0, x0 + 1) * ((1 - wy) * wx)[:, :, None]
            + at(y0 + 1, x0) * (wy * (1 - wx))[:, :, None]
            + at(y0 + 1, x0 + 1) * (wy * wx)[:, :, None])
    cols = cols.reshape(N, C, K, oH, oW)
    if mask is not None:                     # v2 modulation
        m = _t(mask, xa).reshape(N, dg, 1, K, oH, oW)
        cols = (cols.reshape(N, dg, c_per_dg, K, oH, oW) * m) \
            .reshape(N, C, K, oH, oW)
    wg = w.reshape(groups, out_c // groups, c_per_g, K)
    colg = cols.reshape(N, groups, c_per_g, K, oH, oW)
    out = torch.einsum("ngckhw,gock->ngohw", colg, wg)
    out = out.reshape(N, out_c, oH, oW)
    if bias is not None:
        out = out + _t(bias, xa).reshape(1, -1, 1, 1)
    return out


def read_file(filename, name=None):
    """A file's bytes as a uint8 tensor (on the CPU)."""
    with open(filename, "rb") as f:
        data = np.frombuffer(f.read(), dtype=np.uint8).copy()
    return torch.from_numpy(data)


def decode_jpeg(x, mode: str = "unchanged", name=None):
    """JPEG bytes to a ``[C, H, W]`` uint8 tensor on the CPU, decoded on
    the host by PIL (``mode``: ``"unchanged"``, ``"gray"`` or ``"rgb"``)."""
    import io

    from PIL import Image

    if mode not in ("unchanged", "gray", "rgb"):
        raise ValueError(f"decode_jpeg mode must be 'unchanged', 'gray' "
                         f"or 'rgb', got {mode!r}")
    raw = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.uint8)
    img = Image.open(io.BytesIO(raw.astype(np.uint8).tobytes()))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return torch.from_numpy(np.array(arr))


# the detection-head ops (SSD priors, RPN anchors, the box codec, NMS post)
from .detection import (anchor_generator, box_coder,  # noqa: E402,F401
                        multiclass_nms, prior_box)

__all__ += ["prior_box", "anchor_generator", "box_coder",
            "multiclass_nms"]

from .detection_extra import (add_position_encoding,  # noqa: E402,F401
                              bipartite_match, box_clip, bpr_loss,
                              center_loss, collect_fpn_proposals,
                              crf_decoding, cvm, density_prior_box,
                              distribute_fpn_proposals)

__all__ += ["bipartite_match", "box_clip", "density_prior_box",
            "distribute_fpn_proposals", "collect_fpn_proposals",
            "bpr_loss", "center_loss", "cvm", "add_position_encoding",
            "crf_decoding"]
