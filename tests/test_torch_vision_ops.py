"""The port's vision and detection ops against the JAX package on the CPU.

Every op of ``paddle_tpu_torch.vision.ops`` (with ``detection`` and
``detection_extra``), the pooling masks with ``MaxUnPool2D`` and the
quantized convolutions, on inputs drawn from seeded numpy, beside the
JAX op on the same arrays. Tolerances: ``TOL`` (1e-5 of the largest
magnitude of the JAX result) for float outputs and gradients, whose sums
the two packages order differently; the index outputs (``nms``,
``multiclass_nms``, ``bipartite_match``, ``distribute_fpn_proposals``,
``crf_decoding``, the pool masks) and the host-side numpy ops equal the
JAX ones exactly, order included. The cases follow
``tests/test_vision_ops.py``, ``tests/test_detection_ops.py``,
``tests/test_detection_extra.py`` and ``tests/test_new_layers.py``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import ops as J
from paddle_tpu_torch.vision import ops as T

TOL = 1e-5


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err < tol, f"max error {err:.3e} of the largest magnitude"


def _j(a, grad=False):
    t = paddle.to_tensor(a)
    if grad:
        t.stop_gradient = False
    return t


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t._data)


def _boxes(rng, n, size=100.0, min_wh=1.0):
    xy = rng.uniform(0, size * 0.7, (n, 2))
    wh = rng.uniform(min_wh, size * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _grads_match(jfn, tfn, arrays, cot_seed=0):
    """Forward values and the gradients of ``sum(out * cot)`` with respect
    to every array, JAX against the port."""
    jin = [_j(a, True) for a in arrays]
    tin = [_t(a, True) for a in arrays]
    jo, to = jfn(*jin), tfn(*tin)
    _close(_np(to), _np(jo))
    cot = np.random.default_rng(cot_seed).normal(
        size=tuple(to.shape)).astype(np.float32)
    (jo * paddle.to_tensor(cot)).sum().backward()
    (to * torch.tensor(cot)).sum().backward()
    for i, (a, b) in enumerate(zip(jin, tin)):
        _close(b.grad.numpy(), np.asarray(a.grad._data))


# -- boxes and NMS --------------------------------------------------------
def test_box_iou_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 6), _boxes(rng, 9)
    _close(T.box_iou(a, b).numpy(), J.box_iou(_j(a), _j(b)).numpy())


@pytest.mark.parametrize("case", ["scores", "no_scores", "category",
                                  "top_k"])
def test_nms_keeps_the_jax_indices(case):
    rng = np.random.default_rng(1)
    boxes = _boxes(rng, 200)
    scores = rng.permutation(200).astype(np.float32) / 200   # distinct
    cats = rng.integers(0, 3, 200).astype(np.int64)
    kw = {}
    if case != "no_scores":
        kw["scores"] = scores
    if case == "category":
        kw["category_idxs"] = cats
        kw["categories"] = [0, 1, 2]
    if case == "top_k":
        kw["top_k"] = 7
    want = np.asarray(J.nms(_j(boxes), 0.4, **{
        k: (_j(v) if isinstance(v, np.ndarray) else v)
        for k, v in kw.items()}).data)
    got = T.nms(torch.tensor(boxes), 0.4, **{
        k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
        for k, v in kw.items()}).numpy()
    assert got.tolist() == want.tolist()
    assert 0 < len(got) < 200


def test_nms_greedy_reference_cases():
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30],
                      [21, 21, 31, 31], [50, 50, 60, 60]], np.float32)
    scores = np.array([0.9, 0.8, 0.7, 0.95, 0.5], np.float32)
    assert T.nms(boxes, 0.5, scores).tolist() == [3, 0, 4]
    two = boxes[:2]
    assert sorted(T.nms(two, 0.5, scores[:2], category_idxs=np.array(
        [0, 1])).tolist()) == [0, 1]


# -- the RoI family -----------------------------------------------------------
def _rois(rng, n, H, W):
    b = _boxes(rng, n, size=min(H, W) * 1.0, min_wh=0.5)
    return b


@pytest.mark.parametrize("aligned,sr,out", [(True, -1, 4), (False, 3, (3, 5)),
                                            (True, 2, (2, 3))])
def test_roi_align_and_its_gradient_match_jax(aligned, sr, out):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 16, 16)).astype(np.float32)
    rois = _rois(rng, 5, 16, 16) * 2          # spatial_scale 0.5
    num = np.array([2, 3])
    _grads_match(
        lambda a: J.roi_align(a, _j(rois), num, out, spatial_scale=0.5,
                              sampling_ratio=sr, aligned=aligned),
        lambda a: T.roi_align(a, torch.tensor(rois), torch.tensor(num), out,
                              spatial_scale=0.5, sampling_ratio=sr,
                              aligned=aligned), [x])


def test_roi_pool_and_its_gradient_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 12, 14)).astype(np.float32)
    rois = _rois(rng, 6, 12, 14)
    rois[0] = [-3, -3, 1, 1]                 # partly off the map
    rois[1] = [20, 20, 30, 30]               # wholly off: empty bins
    num = np.array([4, 2])
    for out in (2, (3, 4)):
        _grads_match(
            lambda a: J.roi_pool(a, _j(rois), num, out),
            lambda a: T.roi_pool(a, torch.tensor(rois), num, out), [x])
    feat = np.zeros((1, 1, 8, 8), np.float32)
    feat[0, 0, 1, 1], feat[0, 0, 6, 6] = 5.0, 9.0
    o = T.roi_pool(feat, np.array([[0, 0, 7, 7]], np.float32), np.array([1]),
                   2).numpy()
    assert o.max() == 9.0 and o[0, 0, 0, 0] == 5.0


def test_psroi_pool_and_its_gradient_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 2 * 3 * 3, 10, 12)).astype(np.float32)
    rois = _rois(rng, 5, 10, 12)
    num = np.array([3, 2])
    _grads_match(lambda a: J.psroi_pool(a, _j(rois), num, 3),
                 lambda a: T.psroi_pool(a, torch.tensor(rois), num, 3), [x])
    ch = np.broadcast_to(np.arange(12, dtype=np.float32)[None, :, None, None],
                         (1, 12, 8, 8)).copy()
    o = T.psroi_pool(ch, np.array([[0, 0, 8, 8]], np.float32), np.array([1]),
                     2).numpy()
    assert o.reshape(-1).tolist() == list(range(12))


# -- YOLO and the deformable convolution -------------------------------------
@pytest.mark.parametrize("clip,sxy", [(True, 1.0), (False, 1.05)])
def test_yolo_box_matches_jax(clip, sxy):
    rng = np.random.default_rng(5)
    N, A, cls, H, W = 2, 3, 4, 5, 6
    x = rng.normal(size=(N, A * (5 + cls), H, W)).astype(np.float32)
    img = np.array([[320, 352], [288, 320]], np.int32)
    kw = dict(anchors=[10, 13, 16, 30, 33, 23], class_num=cls,
              conf_thresh=0.4, downsample_ratio=32, clip_bbox=clip,
              scale_x_y=sxy)
    jb, js = J.yolo_box(_j(x), _j(img), **kw)
    tb, ts = T.yolo_box(torch.tensor(x), torch.tensor(img), **kw)
    _close(tb.numpy(), jb.numpy())
    _close(ts.numpy(), js.numpy())


@pytest.mark.parametrize("v2,dg,groups", [(False, 1, 1), (True, 2, 2)])
def test_deform_conv2d_and_its_gradients_match_jax(v2, dg, groups):
    rng = np.random.default_rng(6)
    N, C, H, W, OC, K = 2, 4, 7, 8, 6, 3
    x = rng.normal(size=(N, C, H, W)).astype(np.float32)
    oH, oW = (H + 2 - 3) // 2 + 1, (W + 2 - 3) // 2 + 1
    off = (rng.normal(size=(N, dg * 2 * K * K, oH, oW)) * 1.5) \
        .astype(np.float32)
    w = rng.normal(size=(OC, C // groups, K, K)).astype(np.float32)
    b = rng.normal(size=(OC,)).astype(np.float32)
    arrays = [x, off, w, b]
    if v2:
        arrays.append(rng.uniform(size=(N, dg * K * K, oH, oW))
                      .astype(np.float32))

    def call(ops_mod):
        def f(a, o, wt, bias, *m):
            return ops_mod.deform_conv2d(
                a, o, wt, bias=bias, stride=2, padding=1,
                deformable_groups=dg, groups=groups,
                mask=m[0] if m else None)
        return f
    _grads_match(call(J), call(T), arrays)


def test_read_file_and_decode_jpeg_match_jax(tmp_path):
    from PIL import Image
    yy, xx = np.mgrid[0:16, 0:20]
    img = np.stack([yy * 8, xx * 6, (yy + xx) * 4], -1).astype(np.uint8)
    p = tmp_path / "img.jpg"
    Image.fromarray(img).save(p, quality=95)
    data = T.read_file(str(p))
    assert data.dtype == torch.uint8
    np.testing.assert_array_equal(data.numpy(), J.read_file(str(p)).numpy())
    for mode in ("unchanged", "gray", "rgb"):
        np.testing.assert_array_equal(
            T.decode_jpeg(data, mode).numpy(),
            J.decode_jpeg(J.read_file(str(p)), mode).numpy())


# -- the detection head -------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(min_sizes=[30.0], max_sizes=[60.0], aspect_ratios=[2.0], flip=True,
         clip=True),
    dict(min_sizes=[20.0, 40.0], max_sizes=[40.0, 80.0],
         aspect_ratios=[2.0, 3.0], flip=True, clip=False,
         min_max_aspect_ratios_order=True, steps=(8.0, 8.0), offset=0.4),
])
def test_prior_box_matches_jax(kw):
    feat = np.zeros((1, 8, 5, 6), np.float32)
    image = np.zeros((1, 3, 40, 48), np.float32)
    jb, jv = J.prior_box(_j(feat), _j(image), **kw)
    tb, tv = T.prior_box(torch.tensor(feat), torch.tensor(image), **kw)
    _close(tb.numpy(), jb.numpy())
    np.testing.assert_array_equal(tv.numpy(), jv.numpy())


def test_anchor_generator_matches_jax():
    feat = np.zeros((1, 8, 4, 5), np.float32)
    kw = dict(anchor_sizes=[32.0, 64.0], aspect_ratios=[0.5, 1.0, 2.0],
              stride=(16.0, 16.0), offset=0.5)
    ja, jv = J.anchor_generator(_j(feat), **kw)
    ta, tv = T.anchor_generator(torch.tensor(feat), **kw)
    _close(ta.numpy(), ja.numpy())
    np.testing.assert_array_equal(tv.numpy(), jv.numpy())


@pytest.mark.parametrize("norm", [True, False])
def test_box_coder_matches_jax(norm):
    rng = np.random.default_rng(7)
    prior = _boxes(rng, 5, 10.0)
    pvar = (np.abs(rng.normal(size=(5, 4))) + 0.1).astype(np.float32)
    target = _boxes(rng, 3, 10.0)
    for var in (pvar, [0.1, 0.1, 0.2, 0.2], None):
        jv = _j(var) if isinstance(var, np.ndarray) else var
        tv = torch.tensor(var) if isinstance(var, np.ndarray) else var
        enc_j = J.box_coder(_j(prior), jv, _j(target), box_normalized=norm)
        enc_t = T.box_coder(torch.tensor(prior), tv, torch.tensor(target),
                            box_normalized=norm)
        _close(enc_t.numpy(), enc_j.numpy())
        d = np.asarray(enc_j._data) * 0.5
        for axis in (0, 1):
            p = prior if axis == 0 else prior[:3]
            vj = jv if not isinstance(var, np.ndarray) or axis == 0 \
                else _j(var[:3])
            vt = tv if not isinstance(var, np.ndarray) or axis == 0 \
                else torch.tensor(var[:3])
            dd = d if axis == 0 else d[:, :3]
            _close(T.box_coder(torch.tensor(p), vt, torch.tensor(dd),
                               "decode_center_size", norm, axis).numpy(),
                   J.box_coder(_j(p), vj, _j(dd), "decode_center_size",
                               norm, axis).numpy())


@pytest.mark.parametrize("normalized,eta,keep", [(True, 1.0, 20),
                                                 (False, 0.9, -1)])
def test_multiclass_nms_equals_jax(normalized, eta, keep):
    rng = np.random.default_rng(8)
    N, M, C = 2, 60, 5
    scale = 1.0 if normalized else 100.0
    boxes = np.stack([_boxes(rng, M, scale, scale * 0.02)
                      for _ in range(N)])
    scores = rng.uniform(size=(N, C, M)).astype(np.float32)
    kw = dict(score_threshold=0.3, nms_top_k=25, keep_top_k=keep,
              nms_threshold=0.55, normalized=normalized, nms_eta=eta)
    jo, jc = J.multiclass_nms(boxes, scores, **kw)
    to, tc = T.multiclass_nms(torch.tensor(boxes), torch.tensor(scores), **kw)
    np.testing.assert_array_equal(to.numpy(), jo.numpy())
    np.testing.assert_array_equal(tc.numpy(), jc.numpy())
    assert tc.numpy().min() > 0


# -- the detection tail -------------------------------------------------------
@pytest.mark.parametrize("match_type", [None, "per_prediction"])
def test_bipartite_match_equals_jax(match_type):
    rng = np.random.default_rng(9)
    for shape in ((5, 7), (7, 4)):
        d = rng.uniform(size=shape).astype(np.float32)
        ji, jd = J.bipartite_match(_j(d), match_type, 0.3)
        ti, td = T.bipartite_match(torch.tensor(d), match_type, 0.3)
        np.testing.assert_array_equal(ti.numpy(), ji.numpy())
        np.testing.assert_array_equal(td.numpy(), jd.numpy())


def test_box_clip_and_density_prior_box_match_jax():
    rng = np.random.default_rng(10)
    boxes = (rng.normal(size=(2, 6, 4)) * 40 + 20).astype(np.float32)
    info = np.array([[40, 50, 1.0], [60, 30, 2.0]], np.float32)
    _close(T.box_clip(torch.tensor(boxes), torch.tensor(info)).numpy(),
           J.box_clip(_j(boxes), _j(info)).numpy())
    feat = np.zeros((1, 4, 3, 4), np.float32)
    img = np.zeros((1, 3, 48, 64), np.float32)
    for flat in (False, True):
        kw = dict(densities=[2, 1], fixed_sizes=[8.0, 16.0],
                  fixed_ratios=[1.0, 2.0], clip=True, flatten_to_2d=flat)
        jb, jv = J.density_prior_box(_j(feat), _j(img), **kw)
        tb, tv = T.density_prior_box(torch.tensor(feat), torch.tensor(img),
                                     **kw)
        np.testing.assert_array_equal(tb.numpy(), jb.numpy())
        np.testing.assert_array_equal(tv.numpy(), jv.numpy())


def test_fpn_distribute_and_collect_match_jax():
    rng = np.random.default_rng(11)
    rois = _boxes(rng, 30, 600.0, 4.0)
    jm, jr, jc = J.distribute_fpn_proposals(_j(rois), 2, 5, 4, 224)
    tm, tr, tc = T.distribute_fpn_proposals(torch.tensor(rois), 2, 5, 4, 224)
    np.testing.assert_array_equal(tc.numpy(), jc.numpy())
    np.testing.assert_array_equal(tr.numpy(), jr.numpy())
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    scores = [rng.uniform(size=(30, 1)).astype(np.float32) for _ in tm]
    for counts in (None, tc):
        jr2, js2 = J.collect_fpn_proposals(
            jm, [_j(s) for s in scores], 2, 5, 12,
            None if counts is None else jc)
        tr2, ts2 = T.collect_fpn_proposals(
            tm, [torch.tensor(s) for s in scores], 2, 5, 12, counts)
        np.testing.assert_array_equal(tr2.numpy(), jr2.numpy())
        np.testing.assert_array_equal(ts2.numpy(), js2.numpy())


def test_bpr_center_cvm_and_position_encoding_match_jax():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    y = rng.integers(0, 5, (6, 1)).astype(np.int64)
    _grads_match(lambda a: J.bpr_loss(a, _j(y)),
                 lambda a: T.bpr_loss(a, torch.tensor(y)), [x])
    feats = rng.normal(size=(6, 3)).astype(np.float32)
    jc = tc = None
    for _ in range(2):                      # the centers carry across
        jl, jc = J.center_loss(_j(feats), _j(y), 5, 0.3, centers=jc)
        tl, tc = T.center_loss(torch.tensor(feats), torch.tensor(y), 5, 0.3,
                               centers=tc)
        _close(tl.numpy(), jl.numpy())
        _close(tc.numpy(), jc.numpy())
    sc = np.abs(rng.normal(size=(6, 2))).astype(np.float32)
    for use in (True, False):
        _close(T.cvm(torch.tensor(x), torch.tensor(sc), use).numpy(),
               J.cvm(_j(x), _j(sc), use).numpy())
    e = rng.normal(size=(2, 7, 9)).astype(np.float32)
    _close(T.add_position_encoding(torch.tensor(e), 0.7, 1.3).numpy(),
           J.add_position_encoding(_j(e), 0.7, 1.3).numpy())


def test_crf_decoding_equals_jax():
    rng = np.random.default_rng(13)
    em = rng.normal(size=(3, 6, 4)).astype(np.float32)
    tr = rng.normal(size=(4, 4)).astype(np.float32)
    length = np.array([6, 3, 1], np.int64)
    label = rng.integers(0, 4, (3, 6)).astype(np.int64)
    for ln in (None, length):
        jp = J.crf_decoding(_j(em), _j(tr), length=None if ln is None
                            else _j(ln))
        tp = T.crf_decoding(torch.tensor(em), torch.tensor(tr),
                            length=None if ln is None else torch.tensor(ln))
        np.testing.assert_array_equal(tp.numpy(), jp.numpy())
    np.testing.assert_array_equal(
        T.crf_decoding(torch.tensor(em), torch.tensor(tr), torch.tensor(
            label)).numpy(),
        J.crf_decoding(_j(em), _j(tr), _j(label)).numpy())


# -- pooling masks and MaxUnPool2D ---------------------------------------------
@pytest.mark.parametrize("k,s,p", [(2, 2, 0), (3, 2, 1), (3, 1, 2)])
def test_max_pool_mask_and_unpool_match_jax(k, s, p):
    import paddle_tpu.nn.functional as JF
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.nn import functional as TF
    x = np.random.default_rng(14).normal(size=(2, 3, 9, 10)) \
        .astype(np.float32)
    jo, jm = JF.max_pool2d(_j(x), k, s, p, return_mask=True)
    xt = _t(x, True)
    to, tm = TF.max_pool2d(xt, k, s, p, return_mask=True)
    np.testing.assert_array_equal(to.detach().numpy(), jo.numpy())
    np.testing.assert_array_equal(tm.numpy(), jm.numpy())
    assert tm.dtype == torch.int32
    size = None if p == 0 else list(x.shape[2:])
    ju = jnn.MaxUnPool2D(k, s, p, output_size=size)(jo, jm)
    tu = tnn.MaxUnPool2D(k, s, p, output_size=size)(to, tm)
    np.testing.assert_array_equal(tu.detach().numpy(), ju.numpy())
    tu.sum().backward()                     # routed to the maxima
    flat = xt.grad.reshape(2, 3, -1)
    assert float(flat.sum()) == float(np.prod(tm.shape))
    with pytest.raises(ValueError, match="ceil_mode"):
        TF.max_pool2d(xt, 2, return_mask=True, ceil_mode=True)


# -- quantized convolutions ---------------------------------------------------
@pytest.mark.parametrize("transpose", [False, True])
def test_quantized_conv_forward_and_backward_match_jax(transpose):
    from paddle_tpu import nn as jnn
    from paddle_tpu.nn import quant as jq
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.models import load_jax_weights
    from paddle_tpu_torch.nn import quant as tq
    paddle.seed(0)
    if transpose:
        jl = jnn.Conv2DTranspose(6, 4, 3, stride=2, padding=1)
        tl = tnn.Conv2DTranspose(6, 4, 3, stride=2, padding=1, device="cpu")
        jw, tw = jq.QuantizedConv2DTranspose(jl), \
            tq.QuantizedConv2DTranspose(tl)
    else:
        jl = jnn.Conv2D(6, 4, 3, stride=1, padding=1, groups=2)
        tl = tnn.Conv2D(6, 4, 3, stride=1, padding=1, groups=2, device="cpu")
        jw, tw = jq.QuantizedConv2D(jl), tq.QuantizedConv2D(tl)
    load_jax_weights(tl, {k: np.asarray(v._data)
                          for k, v in jl.state_dict().items()})
    x = np.random.default_rng(15).normal(size=(2, 6, 8, 8)).astype(np.float32)
    for step in range(2):                    # the moving range updates
        _grads_match(jw, tw, [x], cot_seed=step)
    _close(tw._fq_a.scale.numpy(), np.asarray(jw._fq_a.scale._data))
