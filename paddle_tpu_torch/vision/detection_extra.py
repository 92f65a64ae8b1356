"""The detection-op tail: counterpart of
``paddle_tpu/vision/detection_extra.py`` (:36-335): matching, FPN
routing, box utilities and the ranking losses that ride the same
pipelines.

- ``bipartite_match``: the JAX greedy (the largest remaining distance,
  first in row-major order, takes its row and column; ``min(R, C)``
  rounds), run on the host in float32 over the matrix read back once, so
  its indices and distances equal the JAX op's.
- ``distribute_fpn_proposals`` keeps the JAX static shapes: one ``[N,
  4]`` tensor a level holding that level's RoIs first (zeros after its
  count), the restore index and the counts.
- ``collect_fpn_proposals`` takes the top ``post_nms_top_n`` scores by a
  stable descending sort (ties in index order, as ``lax.top_k``).
- ``crf_decoding`` is the JAX Viterbi (``text/viterbi.py``) without the
  start and stop rows: max-product with backpointers (the first maximum
  on ties), length-masked, then the backtrace.
- ``density_prior_box`` is host numpy, as in JAX; the rest are
  elementwise and index math on the inputs' device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .ops import _t

__all__ = ["bipartite_match", "box_clip", "density_prior_box",
           "distribute_fpn_proposals", "collect_fpn_proposals",
           "bpr_loss", "center_loss", "cvm", "add_position_encoding",
           "crf_decoding"]


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    """Greedy max-distance matching of each column to a row: ``(match_indices
    [1, C] int32, -1 unmatched; match_distance [1, C] f32)``;
    ``'per_prediction'`` then gives an unmatched column its best row when
    that distance is over ``dist_threshold`` (0.5)."""
    d_t = _t(dist_matrix)
    d = d_t.detach().cpu().numpy().astype(np.float32)
    R, C = d.shape
    neg = np.float32(-1e30)
    dm = d.copy()
    col_idx = np.full((C,), -1, np.int32)
    col_dist = np.zeros((C,), np.float32)
    for _ in range(min(R, C)):
        flat = int(np.argmax(dm))
        r, c = flat // C, flat % C
        best = dm[r, c]
        if not best > neg / 2:
            continue
        col_idx[c] = r
        col_dist[c] = best
        dm[r, :] = neg
        dm[:, c] = neg
    if match_type == "per_prediction":
        thr = 0.5 if dist_threshold is None else float(dist_threshold)
        best_row = np.argmax(d, axis=0).astype(np.int32)
        best_val = np.max(d, axis=0).astype(np.float32)
        take = (col_idx < 0) & (best_val > thr)
        col_idx = np.where(take, best_row, col_idx)
        col_dist = np.where(take, best_val, col_dist)
    dev = d_t.device
    return (torch.as_tensor(col_idx[None, :], device=dev),
            torch.as_tensor(col_dist[None, :], device=dev))


def box_clip(input, im_info, name=None):
    """Clip boxes to their image (``im_info`` rows ``[height, width,
    scale]``)."""
    boxes = _t(input)
    info = _t(im_info, boxes)
    h = info[..., 0] / info[..., 2]
    w = info[..., 1] / info[..., 2]
    hm = (h - 1.0).reshape((-1,) + (1,) * (boxes.dim() - 2))
    wm = (w - 1.0).reshape((-1,) + (1,) * (boxes.dim() - 2))
    x1 = boxes[..., 0].clamp(min=0.0)
    y1 = boxes[..., 1].clamp(min=0.0)
    x2 = boxes[..., 2]
    y2 = boxes[..., 3]
    if boxes.dim() >= 2:
        x1 = torch.minimum(x1, wm)
        y1 = torch.minimum(y1, hm)
        x2 = torch.minimum(x2, wm).clamp(min=0.0)
        y2 = torch.minimum(y2, hm).clamp(min=0.0)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def density_prior_box(input, image=None, densities=None, fixed_sizes=None,
                      fixed_ratios=None, variance=(0.1, 0.1, 0.2, 0.2),
                      clip=False, steps=(0.0, 0.0), offset=0.5,
                      flatten_to_2d=False, name=None):
    """Density prior boxes -> ``(boxes, variances)`` ``[H, W, K, 4]``
    (``[H * W * K, 4]`` with ``flatten_to_2d``): a cell's boxes of the
    fixed sizes and ratios on ``density x density`` sub-grids spaced by
    ``int((step_w + step_h) / 2) / density``."""
    densities = list(densities or [])
    fixed_sizes = list(fixed_sizes or [])
    fixed_ratios = list(fixed_ratios or [])
    img = image if image is not None else input
    H, W = int(input.shape[-2]), int(input.shape[-1])
    img_h, img_w = int(img.shape[-2]), int(img.shape[-1])
    step_w = steps[0] or img_w / W
    step_h = steps[1] or img_h / H
    step_avg = int((step_w + step_h) * 0.5)
    cx = (np.arange(W) + offset) * step_w
    cy = (np.arange(H) + offset) * step_h
    per_cell = []
    for size, dens in zip(fixed_sizes, densities):
        shift = step_avg / dens
        sub = -step_avg / 2.0 + shift / 2.0 + np.arange(dens) * shift
        for ratio in fixed_ratios:
            bw = size * math.sqrt(ratio) / 2.0
            bh = size / math.sqrt(ratio) / 2.0
            dxx, dyy = np.meshgrid(sub, sub)
            per_cell.append(np.stack(
                [dxx - bw, dyy - bh, dxx + bw, dyy + bh],
                axis=-1).reshape(-1, 4))
    offsets = np.concatenate(per_cell, axis=0)            # [K, 4]
    cxy = np.stack(np.meshgrid(cx, cy), axis=-1)          # [H, W, 2]
    centers = np.concatenate([cxy, cxy], axis=-1)         # [H, W, 4]
    out = centers[:, :, None, :] + offsets[None, None]
    out = out / np.array([img_w, img_h, img_w, img_h], np.float32)
    out = out.astype(np.float32)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          out.shape).astype(np.float32)
    if flatten_to_2d:
        out, var = out.reshape(-1, 4), var.reshape(-1, 4).copy()
    dev = input.device if isinstance(input, torch.Tensor) else None
    return (torch.as_tensor(out, device=dev),
            torch.as_tensor(var, device=dev))


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None, name=None):
    """Route RoIs to FPN levels by scale: ``(multi_rois, restore_ind [N,
    1] int32, level_counts)``, ``multi_rois`` one ``[N, 4]`` tensor a
    level with its RoIs first, zeros after ``level_counts[i]`` rows."""
    rois = _t(fpn_rois)
    nlevels = max_level - min_level + 1
    N = rois.shape[0]
    dev = rois.device
    area = (rois[:, 2] - rois[:, 0]).clamp(min=0.0) \
        * (rois[:, 3] - rois[:, 1]).clamp(min=0.0)
    scale = torch.sqrt(area)
    lvl = torch.floor(torch.log2(scale / refer_scale + 1e-8)) + refer_level
    lvl = lvl.clamp(min_level, max_level).to(torch.int32)
    order = torch.argsort(lvl, stable=True)
    rows = torch.arange(N, device=dev)
    multi, counts = [], []
    for i in range(nlevels):
        mask = lvl == (min_level + i)
        cnt = mask.to(torch.int32).sum()
        # this level's RoIs to the front, in order
        idx = torch.argsort((~mask).to(torch.int32), stable=True)
        multi.append(torch.where((rows < cnt)[:, None], rois[idx],
                                 torch.zeros((), dtype=rois.dtype,
                                             device=dev)))
        counts.append(cnt)
    restore = torch.argsort(order, stable=True).to(torch.int32)[:, None]
    return multi, restore, torch.stack(counts)


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, rois_num_per_level=None,
                          name=None):
    """Merge the levels' proposals and keep the ``post_nms_top_n``
    best-scoring: ``(rois, scores [n, 1])``; with ``rois_num_per_level``
    a level's rows past its count score -inf."""
    rois_l = [_t(r) for r in multi_rois]
    scores_l = [_t(s, rois_l[0]).reshape(-1) for s in multi_scores]
    if rois_num_per_level is not None:
        counts = _t(rois_num_per_level, rois_l[0])
        scores_l = [torch.where(torch.arange(s.shape[0], device=s.device)
                                < counts[i], s,
                                torch.full((), -math.inf, dtype=s.dtype,
                                           device=s.device))
                    for i, s in enumerate(scores_l)]
    rois = torch.cat(rois_l, dim=0)
    scores = torch.cat(scores_l, dim=0)
    n = min(int(post_nms_top_n), scores.shape[0])
    top_s, top_i = torch.sort(scores, descending=True, stable=True)
    return rois[top_i[:n]], top_s[:n, None]


def bpr_loss(input, label, name=None):
    """Bayesian Personalized Ranking loss [B, 1]: ``-mean over j != label
    of log sigmoid(x_label - x_j)``."""
    x = _t(input)
    B, C = x.shape
    ids = _t(label, x).long().reshape(-1)
    pos = torch.gather(x, 1, ids[:, None])
    logsig = F.logsigmoid(pos - x)
    mask = F.one_hot(ids, C).to(x.dtype)
    per = -(logsig * (1.0 - mask)).sum(dim=1) / max(C - 1, 1)
    return per[:, None]


def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True, centers=None, name=None):
    """Center loss ``0.5 * ||x - c_label||^2`` [N, 1] and the centers
    (zeros ``[num_classes, D]`` when not given): with ``update_center``
    each class's center moves by ``alpha * sum(diff) / (count + 1)`` in
    place. Pass the returned centers back to keep them across steps."""
    x = _t(input)
    if centers is None:
        centers = torch.zeros((num_classes, int(x.shape[-1])),
                              dtype=torch.float32, device=x.device)
    ids = _t(label, x).long().reshape(-1)
    diff = x - centers[ids]
    loss = 0.5 * (diff * diff).sum(dim=1, keepdim=True)
    if update_center:
        with torch.no_grad():
            counts = torch.zeros(centers.shape[0], dtype=torch.float32,
                                 device=x.device).index_add_(
                0, ids, torch.ones_like(ids, dtype=torch.float32))
            upd = torch.zeros_like(centers).index_add_(0, ids,
                                                       diff.detach())
            centers.add_(alpha * upd / (counts + 1.0)[:, None])
    return loss, centers


def cvm(input, cvm_input, use_cvm=True, name=None):
    """The continuous-value model op: the first two lanes are show and
    click, kept log-adjusted (``use_cvm``) or dropped."""
    x = _t(input)
    sc = _t(cvm_input, x)
    show = torch.log(sc[:, :1] + 1.0)
    click = torch.log(sc[:, 1:2] + 1.0) - torch.log(sc[:, :1] + 1.0)
    if use_cvm:
        return torch.cat([show, click, x[:, 2:]], dim=1)
    return x[:, 2:]


def add_position_encoding(input, alpha, beta, name=None):
    """``alpha * x + beta * PE`` with the sinusoidal encoding ``[sin(p /
    10000^(i/half)), cos(...)]`` over ``x [B, S, E]``."""
    x = _t(input)
    B, S, E = x.shape
    half = E // 2
    f32 = torch.float32
    pos = torch.arange(S, dtype=f32, device=x.device)[:, None]
    div = torch.pow(torch.tensor(10000.0, device=x.device),
                    torch.arange(half, dtype=f32, device=x.device) / half)
    ang = pos / div[None, :]
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
    if pe.shape[1] < E:
        pe = F.pad(pe, (0, E - pe.shape[1]))
    return alpha * x + beta * pe[None, :, :]


def _viterbi_path(emissions, trans, lengths):
    """The best tag path [B, L] int64 (zeros past each length), the JAX
    ``_viterbi`` without the start and stop rows."""
    B, L, C = emissions.shape
    lengths = lengths.to(torch.int64)
    alpha = emissions[:, 0, :]
    ident = torch.arange(C, device=emissions.device)[None, :].expand(B, C)
    bps = []
    for t in range(1, L):
        scores = alpha[:, :, None] + trans[None, :, :]
        best_prev = torch.argmax(scores, dim=1)
        alpha_new = scores.amax(dim=1) + emissions[:, t, :]
        active = (t < lengths)[:, None]
        alpha = torch.where(active, alpha_new, alpha)
        bps.append(torch.where(active, best_prev, ident))
    tag = torch.argmax(alpha, dim=-1)
    path = [tag]
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)
    mask = torch.arange(L, device=path.device)[None, :] < lengths[:, None]
    return torch.where(mask, path, torch.zeros_like(path))


def crf_decoding(input, transition, label=None, length=None, name=None):
    """Viterbi decode: the best path [B, S] int64; with ``label`` the 0/1
    mask of where it agrees (the op's evaluation mode)."""
    x = _t(input)
    B, S = int(x.shape[0]), int(x.shape[1])
    length = torch.full((B,), S, dtype=torch.int64, device=x.device) \
        if length is None else _t(length, x).to(x.device)
    path = _viterbi_path(x, _t(transition, x).to(x.dtype), length)
    if label is not None:
        return (path == _t(label, x).to(path.dtype)).to(torch.int64)
    return path
