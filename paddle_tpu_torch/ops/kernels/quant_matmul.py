"""int8 quantized matmul: wrapper of ``csrc/quant_matmul.cu``.

Counterpart of ``paddle_tpu/ops/pallas/quant_matmul.py``. Replaces the
TPU kernel ``int8_matmul`` (pallas_call at :168): ``x_q [M, K]`` int8 @
``w_q [K, N]`` int8 summed exactly in int32, then the dequantize
epilogue ``acc * (act_scale * w_scale[n])`` in float32, cast to the
output dtype. One scheme across serving and the flag-gated AMP path:
per-output-channel symmetric int8 weights (:func:`quantize_per_channel`)
and per-tensor symmetric int8 activations (:func:`quantize_per_tensor`,
a calibrated static scale or the dynamic absmax).

The quantizers are torch ops, as the JAX package leaves them to XLA
(:99-119), in its order of operations: ``max(absmax / 127, 1e-8)``,
``x32 / scale`` (a true division by a tensor), ``torch.round`` (half to
even, as ``jnp.round``), clip, cast. The dynamic scale stays a 0-dim
tensor on the device and reaches the kernel as a pointer, so a linear
makes no host round trip.

The kernel reads the weight K-major (``wgmma`` takes 8-bit operands
from shared memory only that way). ``w_q [K, N]`` comes either as the
transposed view of a contiguous ``[N, K]`` tensor, as
``slim.QuantizedLinear`` keeps it, which reaches the kernel as it is, or
as a contiguous ``[K, N]``, for which the wrapper makes the K-major copy
(one K*N-byte pass, counted in :data:`layout_copies`); any other layout
raises, on the CPU too.

Given CPU tensors :func:`int8_matmul` computes :func:`int8_matmul_plain`
(the product in float64, exact for these K, then the same epilogue:
bit-equal to the kernel); given CUDA tensors it launches the kernel or
raises. The JAX package's ``PTPU_INT8_BLOCK_*`` variables are TPU tile
sizes and have no counterpart here.
"""

from __future__ import annotations

import torch

from . import INT8_MATMUL as _KERNEL
from . import check, function

__all__ = ["int8_matmul", "int8_matmul_plain", "int8_linear",
           "int8_amp_linear", "quantize_per_channel", "quantize_per_tensor",
           "matmul_shapes_supported", "k_major"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: K-major weight copies the card path has made for a contiguous
#: ``[K, N]`` w_q (the AMP linear's per-forward weights); a plain counter
layout_copies = 0


def matmul_shapes_supported(K: int, N: int) -> bool:
    """The kernel's geometry gate: K and N multiples of 128 (M is
    free)."""
    return K % 128 == 0 and N % 128 == 0


def _qmax(bits: int) -> float:
    return 2.0 ** (bits - 1) - 1


def quantize_per_channel(w, axis: int = 1, bits: int = 8):
    """Symmetric per-channel quantization of a ``[K, N]`` weight along
    the output axis: ``(w_q int8, scale f32 [N])``."""
    qmax = _qmax(bits)
    w32 = w.float()
    red = [i for i in range(w.dim()) if i != axis]
    scale = torch.clamp_min(w32.abs().amax(dim=red) / qmax, 1e-8)
    shaped = scale.reshape([-1 if i == axis else 1 for i in range(w.dim())])
    q = torch.round(w32 / shaped).clamp_(-qmax, qmax).to(torch.int8)
    return q, scale


def quantize_per_tensor(x, act_scale=None, bits: int = 8):
    """Symmetric per-tensor quantization of activations: ``(x_q int8,
    scale f32 0-dim tensor on x's device)``; ``act_scale`` None is the
    dynamic absmax, else a float or a one-element tensor."""
    qmax = _qmax(bits)
    x32 = x.float()
    if act_scale is None:
        scale = torch.clamp_min(x32.abs().amax() / qmax, 1e-8)
    else:
        scale = torch.as_tensor(act_scale, dtype=torch.float32,
                                device=x.device).reshape(())
    q = torch.round(x32 / scale).clamp_(-qmax, qmax).to(torch.int8)
    return q, scale


def _check_shapes(x_q, w_q, w_scale):
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0] \
            or w_scale.shape != (w_q.shape[1],):
        raise ValueError(f"shapes: x_q {tuple(x_q.shape)} [M,K], w_q "
                         f"{tuple(w_q.shape)} [K,N], w_scale "
                         f"{tuple(w_scale.shape)} [N]")
    K, N = w_q.shape
    if not matmul_shapes_supported(K, N):
        raise ValueError(
            f"int8_matmul needs K % 128 == 0 and N % 128 == 0, got K={K}, "
            f"N={N} (slim.QuantizedLinear routes these shapes to its "
            f"plain compositions)")
    if not (k_major(w_q) or w_q.is_contiguous()):
        raise ValueError(
            f"int8_matmul takes w_q [K, N] contiguous or as the transposed "
            f"view of a contiguous [N, K], not strides {w_q.stride()}")


def k_major(w_q) -> bool:
    """Whether ``w_q [K, N]`` is the transposed view of a contiguous
    ``[N, K]``: the layout the kernel reads without a copy."""
    return w_q.t().is_contiguous()


def int8_matmul_plain(x_q, w_q, w_scale, act_scale,
                      out_dtype=torch.float32):
    """The kernel's function in torch: the integer product in float64
    (every partial sum is an integer below 2^53, so it is exact; an int8
    ``@`` would wrap around in int8 on the CPU and does not exist on
    CUDA), converted to float32, times ``act_scale * w_scale``."""
    acc = (x_q.double() @ w_q.double()).float()
    scale = torch.as_tensor(act_scale, dtype=torch.float32,
                            device=x_q.device).reshape(()) * w_scale.float()
    return (acc * scale).to(out_dtype)


def int8_matmul(x_q, w_q, w_scale, act_scale, out_dtype=torch.float32):
    """``x_q [M, K]`` int8 @ ``w_q [K, N]`` int8 with the epilogue
    ``acc * act_scale * w_scale[n]``, ``[M, N]`` in ``out_dtype``
    (float32 or bfloat16 on the card). K and N must be multiples of
    128; ``w_q`` contiguous or K-major (:func:`k_major`). ``act_scale``
    is a one-element float32 tensor (on the CPU also a float)."""
    global layout_copies
    _check_shapes(x_q, w_q, w_scale)
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, w_q, w_scale, act_scale, out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"unsupported device {x_q.device}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError("int8_matmul takes int8 x_q and w_q")
    if w_scale.dtype != torch.float32 \
            or not isinstance(act_scale, torch.Tensor) \
            or act_scale.dtype != torch.float32 or act_scale.numel() != 1:
        raise ValueError("int8_matmul takes a float32 w_scale and a "
                         "one-element float32 act_scale")
    if out_dtype not in _DTYPES:
        raise ValueError(f"int8_matmul writes float32 or bfloat16, not "
                         f"{out_dtype}")
    ts = (x_q, w_q, w_scale, act_scale)
    if any(t.device != x_q.device for t in ts):
        raise ValueError("all arguments must be on one device")
    M, K = x_q.shape
    N = w_q.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
    if M == 0:
        return out
    if k_major(w_q):
        w_t = w_q.t()
    else:
        w_t = w_q.t().contiguous()
        layout_copies += 1
    if not all(t.is_contiguous() for t in (x_q, w_t, w_scale, act_scale)) \
            or x_q.data_ptr() % 16 or w_t.data_ptr() % 16:
        raise ValueError("int8_matmul takes contiguous arguments, x_q and "
                         "w_q 16-byte aligned")
    fn = function(_KERNEL.name)
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    err = fn(x_q.data_ptr(), w_t.data_ptr(), w_scale.data_ptr(),
             act_scale.data_ptr(), out.data_ptr(), M, K, N,
             _DTYPES[out_dtype], stream)
    check(_KERNEL.name, err)
    _KERNEL.launches += 1
    return out


def int8_linear(x, w_q, w_scale, bias=None, act_scale=None):
    """Quantized linear over pre-quantized weights (``slim``'s serving
    path): ``x [..., K]`` quantized per tensor (static ``act_scale`` or
    dynamic absmax), the int8 product, the output in x's dtype, then the
    bias in that dtype (``quant_matmul.py:196-207``)."""
    lead = x.shape[:-1]
    x_q, a_s = quantize_per_tensor(x.reshape(-1, x.shape[-1]), act_scale)
    y = int8_matmul(x_q, w_q, w_scale, a_s, out_dtype=x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.reshape(*lead, w_q.shape[1])


class _AmpMatmul(torch.autograd.Function):
    """Both operands quantized dynamically, then the kernel (on the card
    with the K-major copy of the freshly quantized weight); the backward
    is the straight-through dense pair on the unquantized operands
    (``quant_matmul.py:211-242``)."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        w_q, w_s = quantize_per_channel(w)
        x_q, a_s = quantize_per_tensor(x2)
        return int8_matmul(x_q, w_q, w_s, a_s, out_dtype=x2.dtype)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        dx = (g @ w.t().to(g.dtype)).to(x2.dtype)
        dw = (x2.t().to(g.dtype) @ g).to(w.dtype)
        return dx, dw


def int8_amp_linear(x, w, bias=None):
    """The flag-gated AMP training matmul (``FLAGS_amp_int8_matmul``):
    ``w [K, N]`` a float parameter, both operands quantized per forward,
    a straight-through dense backward."""
    lead = x.shape[:-1]
    y = _AmpMatmul.apply(x.reshape(-1, x.shape[-1]), w)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.reshape(*lead, w.shape[1])
