"""Streamed-vocab cross-entropy: wrappers of ``csrc/chunked_ce.cu``.

Replaces two TPU kernels of ``paddle_tpu/ops/pallas/chunked_ce.py``:
``_online_lse`` (pallas_call at :128) and ``_dlogits`` (pallas_call at
:168). Memory bounds both; the source's header says what the design
does about it.

- :func:`online_lse` -- row logsumexp ``[N]`` (f32) of ``[N, V]``
  logits; a row whose exponentials sum to 0 gets ``NEG_INF``.
- :func:`dlogits` -- ``(exp(logits - lse) - onehot(labels)) * g`` in the
  logits' dtype, with the ``lse == NEG_INF -> shift 0`` guard.
- :func:`chunked_ce_loss` -- the differentiable per-row loss
  ``lse - logits[n, labels[n]]`` over the two, as
  ``chunked_ce.py::chunked_ce_loss``.

The plain versions mirror ``nn/chunked_ce.py::_ce_hard`` (:95-129): the
online (m, s) recurrence over ``PLAIN_CHUNK``-wide vocab slices in f32
and the closed-form gradient; the kernel walks whole rows, so the slice
width changes only the plain version's summation order. Given CPU tensors the wrappers compute them; given
CUDA tensors they launch the kernels or raise.
"""

from __future__ import annotations

import torch

from ..attention import NEG_INF
from . import CHUNKED_CE_DLOGITS as _DLOGITS
from . import CHUNKED_CE_LSE as _LSE
from . import check, costing, function, note_cost, uncounted

__all__ = ["online_lse", "dlogits", "online_lse_plain", "dlogits_plain",
           "chunked_ce_loss"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: vocab slice of the plain versions (the JAX flag default)
PLAIN_CHUNK = 8192


def online_lse_plain(logits: torch.Tensor) -> torch.Tensor:
    """Row logsumexp by the online (m, s) recurrence over vocab chunks."""
    N, V = logits.shape
    m = torch.full((N,), NEG_INF, dtype=torch.float32, device=logits.device)
    s = torch.zeros((N,), dtype=torch.float32, device=logits.device)
    for c in range(0, V, PLAIN_CHUNK):
        sl = logits[:, c:c + PLAIN_CHUNK].float()
        m_new = torch.maximum(m, sl.max(dim=1).values)
        shift = torch.where(m_new == NEG_INF, 0.0, m_new)
        s = s * torch.exp(m - shift) + torch.exp(sl - shift[:, None]).sum(1)
        m = m_new
    safe = torch.where(s == 0.0, 1.0, s)
    return torch.where(s == 0.0, NEG_INF, m + torch.log(safe))


def dlogits_plain(logits, labels, lse, g) -> torch.Tensor:
    """``(exp(logits - lse) - onehot(labels)) * g`` in the logits' dtype."""
    shift = torch.where(lse == NEG_INF, 0.0, lse)
    p = torch.exp(logits.float() - shift[:, None])
    cols = torch.arange(logits.shape[1], device=logits.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    return ((p - onehot) * g.float()[:, None]).to(logits.dtype)


def _check(logits):
    if logits.dim() != 2:
        raise ValueError(f"logits must be [N, V], got {tuple(logits.shape)}")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {logits.device}")
    if logits.device.type == "cuda" and logits.dtype not in _DTYPES:
        raise ValueError(f"chunked-CE kernels take float32 or bfloat16 "
                         f"logits, got {logits.dtype}")


def online_lse(logits: torch.Tensor) -> torch.Tensor:
    """Row logsumexp ``[N]`` float32 of ``logits [N, V]``."""
    _check(logits)
    if costing():
        N, V = logits.shape
        note_cost(_LSE.name, 0, N * V * logits.element_size() + N * 4)
    if logits.device.type == "cpu":
        with uncounted():
            return online_lse_plain(logits)
    logits = logits.contiguous()
    N, V = logits.shape
    lse = torch.empty((N,), dtype=torch.float32, device=logits.device)
    err = function(_LSE.name)(
        logits.data_ptr(), lse.data_ptr(), N, V, _DTYPES[logits.dtype],
        torch.cuda.current_stream(logits.device).cuda_stream)
    check(_LSE.name, err)
    _LSE.launches += 1
    return lse


def dlogits(logits, labels, lse, g) -> torch.Tensor:
    """Gradient of the per-row loss wrt ``logits [N, V]`` for the
    upstream per-row gradient ``g [N]``; in the logits' dtype."""
    _check(logits)
    N, V = logits.shape
    if labels.shape != (N,) or lse.shape != (N,) or g.shape != (N,):
        raise ValueError(f"labels {tuple(labels.shape)}, lse "
                         f"{tuple(lse.shape)} and g {tuple(g.shape)} must "
                         f"be [N={N}]")
    if costing():
        note_cost(_DLOGITS.name, 0,
                  2 * N * V * logits.element_size() + N * 12)
    if logits.device.type == "cpu":
        with uncounted():
            return dlogits_plain(logits, labels, lse, g)
    logits = logits.contiguous()
    labels = labels.to(torch.int32).contiguous()
    lse = lse.float().contiguous()
    g = g.float().contiguous()
    out = torch.empty_like(logits)
    err = function(_DLOGITS.name)(
        logits.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
        out.data_ptr(), N, V, _DTYPES[logits.dtype],
        torch.cuda.current_stream(logits.device).cuda_stream)
    check(_DLOGITS.name, err)
    _DLOGITS.launches += 1
    return out


class _ChunkedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        lse = online_lse(logits)
        tgt = logits.gather(1, labels.long()[:, None])[:, 0]
        ctx.save_for_backward(logits, labels, lse)
        return lse - tgt.float()

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return dlogits(logits, labels, lse, g), None


def chunked_ce_loss(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Per-row hard-label NLL ``[N]`` float32 of ``logits [N, V]``;
    differentiable in ``logits``. The caller maps ignored labels to a
    safe id and masks the result."""
    return _ChunkedCE.apply(logits, labels)
