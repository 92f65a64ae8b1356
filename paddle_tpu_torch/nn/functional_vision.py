"""The vision ops: convolutions, pools, batch norm, activations.

Counterpart of the vision part of ``paddle_tpu/nn/functional.py``
(``conv*`` :350-480, pools :487-697, ``batch_norm`` :799-888,
``fused_conv_bn`` :891-1011), with the JAX package's semantics; re-exported
by ``nn.functional``. None of them reached a Pallas kernel in the JAX
package (XLA lowered them), so here they are PyTorch's own calls: cuDNN
for the convolutions and pools on the card.

- ``conv*``: ``[out, in/groups, *k]`` weights (``[in, out/groups, *k]``
  for a transpose), int, per-dimension, per-side (a list of pairs) or
  ``"SAME"`` / ``"VALID"`` padding (XLA's split of a ``SAME`` pad: the
  smaller half before); a channels-last ``data_format`` (``NLC``,
  ``NHWC``, ``NDHWC``) takes and returns logically channels-last
  tensors. A transpose takes a string padding as zero padding and
  ignores ``output_size``, as the JAX op does (``functional.py:435-440``).
  Under AMP O1 the inputs are cast to bf16 (``conv*`` are on the white
  list); cuDNN's bf16 convolution accumulates in f32 and rounds once, as
  ``_conv_accum_f32`` does. A float32 convolution is float32 whatever
  ``torch.backends.cudnn.allow_tf32`` says: forward and backward run with
  TF32 off (:class:`_Conv`), so the card computes what the CPU computes.
  A 2-D input in ``torch.channels_last`` makes the weight channels-last
  too (one conversion inside the op's own cast), so cuDNN runs NHWC.
- pools: ``padding`` int, per-dimension or a string; max pools pad with
  -inf, ``exclusive=True`` average pools divide by the window's count of
  real elements (``count_include_pad=False``), a string padding divides
  by the whole window; ``ceil_mode`` is accepted and ignored (the JAX op
  floors the output size whatever it says, :487-542). Adaptive pools
  take bins ``floor(i*H/o) .. ceil((i+1)*H/o)`` (PyTorch's and the JAX
  op's). ``max_pool2d(return_mask=True)`` / ``max_pool2d_with_index``
  return flat ``h * W + w`` indices a channel, which ``max_unpool2d``
  (``MaxUnPool2D``) scatters back.
- ``batch_norm``: the JAX recipe, not ``F.batch_norm`` (whose running
  variance is unbiased and whose momentum is the complement):
  statistics in f32 from the input (the biased variance), ``scale =
  gamma * rsqrt(var + eps)`` and ``shift = beta - mean * scale`` folded in
  f32, then ``a * scale + shift`` in the input's dtype; running
  statistics ``m * old + (1 - m) * batch`` written in place, in f32,
  under ``no_grad``. In training the op is one autograd node that saves
  the input (bf16 under O1) and the f32 mean and rstd, not an f32 copy
  of every activation. It is never cast by AMP (``amp._keep_dtype``).
- ``fused_conv_bn``: the conv (AMP cast on its operands only), batch
  norm and relu / relu6 in sequence, the same arithmetic as the three
  ops (the JAX op fused them for XLA's epilogue; here they stay three
  PyTorch calls).
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..amp import cast_inputs
from .layout import is_channels_last

__all__ = [
    "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
    "conv3d_transpose", "max_pool1d", "max_pool2d", "max_pool3d",
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
    "adaptive_avg_pool2d", "adaptive_avg_pool3d", "adaptive_max_pool1d",
    "adaptive_max_pool2d", "adaptive_max_pool3d", "max_pool2d_with_index",
    "max_unpool2d", "batch_norm",
    "fused_conv_bn", "relu", "relu6", "sigmoid", "flatten",
]

_CHANNEL_LAST = ("NLC", "NHWC", "NDHWC")


def _ntuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(int(i) for i in v)


def _to_channel_first(x, channel_last: bool):
    return x.movedim(-1, 1) if channel_last else x


def _from_channel_first(x, channel_last: bool):
    return x.movedim(1, -1) if channel_last else x


def _same_pads(sizes, windows, strides):
    """XLA's ``padtype_to_pads(..., "SAME")``: the output is
    ``ceil(size / stride)``, the pad split with the smaller half first."""
    pads = []
    for size, k, s in zip(sizes, windows, strides):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _explicit_pad(x, pads, value=0.0):
    """Pad the trailing ``len(pads)`` dims of ``x`` by ``(lo, hi)`` each
    (a negative side crops, as an XLA pad does)."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


# -- convolutions --------------------------------------------------------
class _Conv(torch.autograd.Function):
    """``aten.convolution`` and its backward with TF32 off for a float32
    convolution: the global ``allow_tf32`` flag is read when a kernel is
    chosen, which for the backward is when autograd runs it, so both
    directions set it themselves."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, transposed,
                output_padding, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, transposed, output_padding,
                    groups, b is not None)
        with _f32_exact(x):
            return torch.ops.aten.convolution(
                x, w, b, stride, padding, dilation, transposed,
                output_padding, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        (stride, padding, dilation, transposed, output_padding, groups,
         has_bias) = ctx.conf
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                has_bias and ctx.needs_input_grad[2]]
        with _f32_exact(x):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g, x, w, [w.shape[1 if transposed else 0] * (
                    groups if transposed else 1)] if has_bias else None,
                stride, padding, dilation, transposed, output_padding,
                groups, mask)
        return gx, gw, gb, None, None, None, None, None, None


# one float32 CUDA convolution at a time sets, uses and restores the
# process-wide flag, so threads (engines, predictors) cannot interleave
_TF32_LOCK = threading.Lock()


class _f32_exact:
    """TF32 off in cuDNN for a float32 CUDA convolution, restored after,
    under ``_TF32_LOCK``."""

    def __init__(self, x):
        self.on = x.is_cuda and x.dtype == torch.float32

    def __enter__(self):
        if self.on:
            _TF32_LOCK.acquire()
            self.prev = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        if self.on:
            torch.backends.cudnn.allow_tf32 = self.prev
            _TF32_LOCK.release()


def _conv_weight_format(x, w):
    if w.dim() == 4 and is_channels_last(x):
        return w.contiguous(memory_format=torch.channels_last)
    return w


def _conv_nd(x, weight, bias, stride, padding, dilation, groups,
             data_format, n):
    op = f"conv{n}d"
    x, weight, bias = cast_inputs(op, x, weight, bias)
    stride = _ntuple(stride, n)
    dilation = _ntuple(dilation, n)
    channel_last = data_format in _CHANNEL_LAST
    x = _to_channel_first(x, channel_last)
    if isinstance(padding, str):
        pad = padding.upper()
        if pad not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}: expected 'SAME', "
                             "'VALID' or integers")
        eff = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilation)]
        pads = _same_pads(x.shape[2:], eff, stride) if pad == "SAME" \
            else [(0, 0)] * n
    elif isinstance(padding, (list, tuple)) and padding \
            and isinstance(padding[0], (list, tuple)):
        pads = [tuple(int(v) for v in p) for p in padding]
    else:
        pads = [(p, p) for p in _ntuple(padding, n)]
    if all(lo == hi for lo, hi in pads):
        sym = [lo for lo, _ in pads]
    else:
        x = _explicit_pad(x, pads)
        sym = [0] * n
    w = _conv_weight_format(x, weight)
    out = _Conv.apply(x, w, bias, list(stride), sym, list(dilation), False,
                      [0] * n, groups)
    return _from_channel_first(out, channel_last)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 3)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, data_format, n):
    op = f"conv{n}d_transpose"
    x, weight, bias = cast_inputs(op, x, weight, bias)
    stride = _ntuple(stride, n)
    dilation = _ntuple(dilation, n)
    # a string padding is zero padding here, as in the JAX op
    pads = (0,) * n if isinstance(padding, str) else _ntuple(padding, n)
    opad = _ntuple(output_padding, n) if output_padding else (0,) * n
    channel_last = data_format in _CHANNEL_LAST
    x = _to_channel_first(x, channel_last)
    w = _conv_weight_format(x, weight)
    out = _Conv.apply(x, w, bias, list(stride), list(pads), list(dilation),
                      True, list(opad), groups)
    return _from_channel_first(out, channel_last)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, data_format,
                              1)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, data_format,
                              2)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, data_format,
                              3)


# -- pools ---------------------------------------------------------------
def _pool_nd(x, kernel_size, stride, padding, n, reducer, data_format,
             count_include_pad=True, divisor_override=None):
    ks = _ntuple(kernel_size, n)
    st = _ntuple(stride if stride is not None else kernel_size, n)
    channel_last = data_format in _CHANNEL_LAST
    a = _to_channel_first(x, channel_last)
    if isinstance(padding, str):
        mode = padding.upper()
        pads = _same_pads(a.shape[2:], ks, st) if mode == "SAME" \
            else [(0, 0)] * n
        string_pad = True
    else:
        pads = [(p, p) for p in _ntuple(padding, n)]
        string_pad = False
    if n == 1:                      # run as 2-D over a unit height
        a, ks, st, pads = a.unsqueeze(2), (1,) + ks, (1,) + st, \
            [(0, 0)] + pads
    m = len(ks)
    # PyTorch pads inside the pool only symmetrically and up to half a
    # window; anything else is padded first, with the reducer's identity
    native = all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, ks))
    if reducer == "max":
        if not native:
            a = _explicit_pad(a, pads, value=-math.inf)
            pads = [(0, 0)] * m
        pool = F.max_pool2d if m == 2 else F.max_pool3d
        out = pool(a, ks, st, [lo for lo, _ in pads])
    else:
        pool = F.avg_pool2d if m == 2 else F.avg_pool3d
        # a string padding divides by the whole window; so do int pads
        # with count_include_pad, and none at all
        whole = string_pad or count_include_pad or not any(
            lo or hi for lo, hi in pads)
        div = divisor_override or None
        if native:
            out = pool(a, ks, st, [lo for lo, _ in pads],
                       count_include_pad=whole, divisor_override=div)
        else:
            padded = _explicit_pad(a, pads)
            if whole or div:
                out = pool(padded, ks, st, 0, divisor_override=div)
            else:
                sums = pool(padded, ks, st, 0, divisor_override=1)
                ones = _explicit_pad(torch.ones_like(a[:1, :1]), pads)
                out = sums / pool(ones, ks, st, 0, divisor_override=1)
    if n == 1:
        out = out.squeeze(2)
    return _from_channel_first(out, channel_last)


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False):
    return _pool_nd(x, kernel_size, stride, padding, 1, "max", "NCL")


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    if return_mask:
        if data_format != "NCHW" or ceil_mode:
            raise ValueError("return_mask supports NCHW, ceil_mode=False")
        return max_pool2d_with_index(x, kernel_size, stride, padding)
    return _pool_nd(x, kernel_size, stride, padding, 2, "max", data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW"):
    return _pool_nd(x, kernel_size, stride, padding, 3, "max", data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False):
    return _pool_nd(x, kernel_size, stride, padding, 1, "avg", "NCL",
                    count_include_pad=not exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    return _pool_nd(x, kernel_size, stride, padding, 2, "avg", data_format,
                    count_include_pad=not exclusive,
                    divisor_override=divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW"):
    return _pool_nd(x, kernel_size, stride, padding, 3, "avg", data_format,
                    count_include_pad=not exclusive,
                    divisor_override=divisor_override)


_ADAPTIVE = {("avg", 1): F.adaptive_avg_pool1d,
             ("avg", 2): F.adaptive_avg_pool2d,
             ("avg", 3): F.adaptive_avg_pool3d,
             ("max", 1): F.adaptive_max_pool1d,
             ("max", 2): F.adaptive_max_pool2d,
             ("max", 3): F.adaptive_max_pool3d}


def _adaptive_pool(x, output_size, n, mode, data_format):
    if isinstance(output_size, (int, np.integer)) or output_size is None:
        output_size = (output_size,) * n
    sizes = tuple(None if o is None else int(o) for o in output_size)
    channel_last = data_format in _CHANNEL_LAST
    a = _to_channel_first(x, channel_last)
    out = _ADAPTIVE[mode, n](a, sizes if n > 1 else sizes[0])
    return _from_channel_first(out, channel_last)


def adaptive_avg_pool1d(x, output_size):
    return _adaptive_pool(x, output_size, 1, "avg", "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return _adaptive_pool(x, output_size, 2, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return _adaptive_pool(x, output_size, 3, "avg", data_format)


def _no_mask(return_mask: bool, n: int) -> None:
    if return_mask:
        raise NotImplementedError(
            f"adaptive_max_pool{n}d: return_mask not supported; use "
            "max_pool2d_with_index for pooled indices")


def adaptive_max_pool1d(x, output_size, return_mask=False):
    _no_mask(return_mask, 1)
    return _adaptive_pool(x, output_size, 1, "max", "NCL")


def adaptive_max_pool2d(x, output_size, return_mask=False):
    _no_mask(return_mask, 2)
    return _adaptive_pool(x, output_size, 2, "max", "NCHW")


def adaptive_max_pool3d(x, output_size, return_mask=False):
    _no_mask(return_mask, 3)
    return _adaptive_pool(x, output_size, 3, "max", "NCDHW")


def max_pool2d_with_index(x, kernel_size, stride=None, padding=0):
    """Max pool returning ``(out, indices)``: each output's flat
    ``h * W + w`` position in its channel of the unpadded input, the first
    maximum of its window in (kh, kw) order (``functional.py:664``). The
    input is padded with its dtype's lowest finite value first, as the
    JAX op pads, so a pad wider than half the window is taken too."""
    ks = _ntuple(kernel_size, 2)
    st = _ntuple(stride if stride is not None else kernel_size, 2)
    pads = _ntuple(padding, 2)
    a = x.contiguous()
    W = a.shape[3]
    if pads[0] or pads[1]:
        low = torch.finfo(a.dtype).min if a.is_floating_point() \
            else torch.iinfo(a.dtype).min
        a = F.pad(a, (pads[1], pads[1], pads[0], pads[0]), value=low)
    out, pidx = F.max_pool2d(a, ks, st, return_indices=True)
    wp = a.shape[3]
    row = torch.div(pidx, wp, rounding_mode="floor") - pads[0]
    col = pidx % wp - pads[1]
    return out, (row * W + col).to(torch.int32)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW"):
    """Scatter each pooled value back to its flat per-channel position,
    zeros elsewhere (``functional.py:700``); the output is
    ``output_size[-2:]`` or ``(o - 1) * stride - 2 * pad + k`` a side."""
    if data_format != "NCHW":
        raise ValueError("max_unpool2d supports NCHW only")
    ks = _ntuple(kernel_size, 2)
    st = _ntuple(stride if stride is not None else kernel_size, 2)
    pads = _ntuple(padding, 2)
    N, C, oH, oW = x.shape
    if output_size is not None:
        H, W = int(output_size[-2]), int(output_size[-1])
    else:
        H = (oH - 1) * st[0] - 2 * pads[0] + ks[0]
        W = (oW - 1) * st[1] - 2 * pads[1] + ks[1]
    flat = x.reshape(N, C, oH * oW)
    idx = indices.reshape(N, C, oH * oW).long()
    out = flat.new_zeros(N, C, H * W).scatter(2, idx, flat)
    return out.reshape(N, C, H, W)


# -- batch norm ----------------------------------------------------------
def _fold_scale_shift(mean, var, gamma, beta, epsilon):
    """BN statistics (+ the optional affine) folded into one f32 (scale,
    shift) pair (``functional.py:799-810``)."""
    inv = torch.rsqrt(var + epsilon)
    if gamma is None:
        return inv, -mean * inv
    scale = gamma.to(inv.dtype) * inv
    return scale, beta.to(inv.dtype) - mean * scale


def _apply_scale_shift(a, scale, shift):
    """``a * scale + shift`` in ``a``'s dtype, channel axis 1."""
    shape = (1, -1) + (1,) * (a.dim() - 2)
    return torch.addcmul(shift.to(a.dtype).view(shape), a,
                         scale.to(a.dtype).view(shape))


class _BatchNormTrain(torch.autograd.Function):
    """Batch statistics and the normalisation as one autograd node
    (channel axis 1). It saves ``a`` in its own dtype and the f32 mean
    and rstd; the backward is the batch-norm gradient over the same
    statistics (``aten.native_batch_norm_backward``, f32 arithmetic),
    which is the JAX recipe's exact gradient: ``d(a * scale + shift)``
    through the batch mean and biased variance."""

    @staticmethod
    def forward(ctx, a, weight, bias, epsilon):
        axes = [0] + list(range(2, a.dim()))
        acc = torch.promote_types(a.dtype, torch.float32)
        var, mean = torch.var_mean(a.to(acc), dim=axes, correction=0)
        rstd = torch.rsqrt(var + epsilon)
        scale, shift = _fold_scale_shift(mean, var, weight, bias, epsilon)
        ctx.save_for_backward(a, weight, mean, rstd)
        ctx.epsilon = epsilon
        ctx.mark_non_differentiable(mean, var)
        return _apply_scale_shift(a, scale, shift), mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        a, weight, mean, rstd = ctx.saved_tensors
        affine = weight is not None
        w32 = weight.to(mean.dtype) if affine else None
        gx, gw, gb = torch.ops.aten.native_batch_norm_backward(
            g, a, w32, None, None, mean, rstd, True, ctx.epsilon,
            [ctx.needs_input_grad[0], affine and ctx.needs_input_grad[1],
             affine and ctx.needs_input_grad[2]])
        if gw is not None:
            gw = gw.to(weight.dtype)
        if gb is not None:
            gb = gb.to(weight.dtype)
        return gx, gw, gb, None


def _all_ranks(t, groups):
    """Sum ``t`` over each group in turn (in place; returns it)."""
    from ..distributed.collective import all_reduce
    for g in groups:
        all_reduce(t, group=g)
    return t


def _global_moments(n, mean, m2, groups):
    """The global count, mean and centred second moment of per-rank
    ``(n, mean, m2)`` (``m2`` the sum of squared deviations from the
    rank's mean), by the parallel-variance formula: every rank's triple
    lands in its own row of a zero buffer summed over the group (one
    collective a group, exact: a row's other terms are 0), then each rank
    combines the rows in rank order, ``N = sum n_r``, ``mean = sum n_r
    mean_r / N``, ``M2 = sum (m2_r + n_r (mean_r - mean)^2)``, so every
    rank computes the same bits."""
    for g in groups:
        rows = mean.new_zeros(g.nranks, 3, mean.numel())
        rows[g.rank, 0] = n
        rows[g.rank, 1] = mean
        rows[g.rank, 2] = m2
        rows = _all_ranks(rows, [g])
        ns, means, m2s = rows[:, 0], rows[:, 1], rows[:, 2]
        n = ns.sum(0)
        mean = (ns * means).sum(0) / n
        m2 = (m2s + ns * (means - mean) ** 2).sum(0)
    return n, mean, m2


class _BatchNormGlobal(torch.autograd.Function):
    """``_BatchNormTrain`` with its statistics over the global batch of a
    data-parallel mesh: each rank holds its rows, the forward combines the
    ranks' per-channel count, mean and centred second moment
    (:func:`_global_moments`, f32 from the input whatever its dtype), and
    the backward all-reduces ``[sum dy, sum dy * (a - mean)]`` a channel
    (one collective) before the elementwise gradient ``dx = gamma * rstd *
    (dy - sum dy / N - (a - mean) * rstd^2 * sum dy (a - mean) / N)``. Each
    rank's ``dy`` is its own loss's cotangent and the step averages the
    parameter gradients over the data ranks, so ``dx`` is the data-rank
    count times the global loss's, as every other rank-local gradient is;
    the affine gradients are the rank's own sums, averaged by the step."""

    @staticmethod
    def forward(ctx, a, weight, bias, epsilon, groups):
        axes = [0] + list(range(2, a.dim()))
        acc = torch.promote_types(a.dtype, torch.float32)
        var, mean = torch.var_mean(a.to(acc), dim=axes, correction=0)
        n = float(a.numel() // a.shape[1])
        count, mean, m2 = _global_moments(
            torch.full_like(mean, n), mean, var * n, groups)
        var = m2 / count
        rstd = torch.rsqrt(var + epsilon)
        scale, shift = _fold_scale_shift(mean, var, weight, bias, epsilon)
        ctx.save_for_backward(a, weight, mean, rstd, count)
        ctx.groups = groups
        ctx.mark_non_differentiable(mean, var)
        return _apply_scale_shift(a, scale, shift), mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        a, weight, mean, rstd, count = ctx.saved_tensors
        axes = [0] + list(range(2, a.dim()))
        shape = (1, -1) + (1,) * (a.dim() - 2)
        g32 = g.to(mean.dtype)
        xmu = a.to(mean.dtype) - mean.view(shape)
        sums = torch.stack([g32.sum(axes), (g32 * xmu).sum(axes)])
        local = sums.clone()
        sums = _all_ranks(sums, ctx.groups)
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            k = rstd if weight is None else weight.to(rstd.dtype) * rstd
            gx = (g32 - (sums[0] / count).view(shape)
                  - xmu * (rstd * rstd * sums[1] / count).view(shape)) \
                * k.view(shape)
            gx = gx.to(a.dtype)
        if weight is not None:
            if ctx.needs_input_grad[1]:
                gw = (local[1] * rstd).to(weight.dtype)
            if ctx.needs_input_grad[2]:
                gb = local[0].to(weight.dtype)
        return gx, gw, gb, None, None


def _update_running(running_mean, running_var, mean, var, momentum):
    with torch.no_grad():
        running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
        running_var.copy_(momentum * running_var + (1 - momentum) * var)


def _batch_norm_global(x, running_mean, running_var, weight, bias, groups,
                      momentum=0.9, epsilon=1e-5, data_format="NCHW"):
    """Training-mode :func:`batch_norm` whose statistics are taken over
    the global batch held by the ranks of ``groups`` (the data groups of
    a mesh, each of more than one rank): the same output, running
    statistics and gradients as one process's ``batch_norm`` on the
    whole batch, to f32 reassociation; the running statistics come out
    the same on every rank."""
    channel_last = data_format in _CHANNEL_LAST
    a = _to_channel_first(x, channel_last)
    out, mean, var = _BatchNormGlobal.apply(a, weight, bias, float(epsilon),
                                            list(groups))
    _update_running(running_mean, running_var, mean, var, momentum)
    return _from_channel_first(out, channel_last)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """BatchNorm by the JAX recipe (module docstring). In training mode
    (and not ``use_global_stats``) the batch statistics normalise and
    ``running_mean`` / ``running_var`` take ``momentum * old + (1 -
    momentum) * batch`` in place."""
    channel_last = data_format in _CHANNEL_LAST
    a = _to_channel_first(x, channel_last)
    if training and not use_global_stats:
        out, mean, var = _BatchNormTrain.apply(a, weight, bias,
                                               float(epsilon))
        _update_running(running_mean, running_var, mean, var, momentum)
    else:
        acc = torch.promote_types(running_mean.dtype, torch.float32)
        scale, shift = _fold_scale_shift(running_mean.to(acc),
                                         running_var.to(acc), weight, bias,
                                         epsilon)
        out = _apply_scale_shift(a, scale, shift)
    return _from_channel_first(out, channel_last)


def fused_conv_bn(x, weight, bias, running_mean, running_var, bn_weight,
                  bn_bias, stride=1, padding=0, dilation=1, groups=1,
                  data_format="NCHW", training=False, momentum=0.9,
                  epsilon=1e-5, activation=None, use_global_stats=None):
    """Conv2D -> BatchNorm -> activation (``None``, ``"relu"`` or
    ``"relu6"``): the conv's operands take the AMP cast of ``conv2d``,
    the batch norm none, so the f32 running statistics are never rounded
    through bf16."""
    if activation not in (None, "relu", "relu6"):
        raise ValueError(f"fused_conv_bn supports relu/relu6, got "
                         f"{activation!r}")
    out = conv2d(x, weight, bias, stride, padding, dilation, groups,
                 data_format)
    out = batch_norm(out, running_mean, running_var, bn_weight, bn_bias,
                     training, momentum, epsilon, data_format,
                     use_global_stats)
    if activation == "relu":
        return relu(out)
    if activation == "relu6":
        return relu6(out)
    return out


# -- activations and shape -------------------------------------------------
def relu(x):
    return torch.relu(x)


def relu6(x):
    return F.hardtanh(x, 0.0, 6.0)


def sigmoid(x):
    return torch.sigmoid(x)


def flatten(x, start_axis: int = 0, stop_axis: int = -1):
    """Merge dims ``start_axis .. stop_axis`` of the logical shape (a
    channels-last tensor flattens in NCHW order, as the JAX op's exit
    transpose gives it)."""
    return torch.flatten(x, start_axis, stop_axis)
