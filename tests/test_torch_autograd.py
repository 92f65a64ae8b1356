"""Eager autograd of the port against the JAX facade: the cases of
``tests/test_autograd.py`` (backward, accumulation across two
backwards, stop_gradient, detach, no_grad, hooks, ``retain_grads``,
``paddle.grad``, ``PyLayer``, jacobian, hessian, vjp, jvp) run through
both packages on the same numpy inputs. f32 gradients within rtol 1e-5
/ atol 1e-6, the functional transforms within 1e-5."""

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as pp
from _torch_eager_cases import port_on_cpu  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


def both(fn):
    """``fn(pkg)`` (numpy results) in both packages, compared."""
    j, p = fn(jp), fn(pp)
    j = j if isinstance(j, (list, tuple)) else [j]
    p = p if isinstance(p, (list, tuple)) else [p]
    assert len(j) == len(p)
    for a, b in zip(j, p):
        if a is None or b is None:
            assert a is None and b is None
            continue
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **TOL)
    return p


def _x(pkg, v, sg=False):
    return pkg.to_tensor(np.asarray(v, np.float32), stop_gradient=sg)


def test_simple_backward_and_chain():
    def f(pkg):
        x = _x(pkg, [1.0, 2.0, 3.0])
        (x * x).sum().backward()
        y = _x(pkg, 2.0)
        (y * 3.0 + y * 5.0).backward()
        # the JAX facade's gradient is a property, Paddle's (and the
        # port's) a method
        g = x.gradient() if pkg is pp else x.gradient
        return x.grad.numpy(), y.grad.numpy(), g
    both(f)


def test_grad_accumulates_across_two_backwards():
    def f(pkg):
        x = _x(pkg, 1.0)
        (x * 2).backward()
        first = x.grad.numpy().copy()
        (x * 3).backward()
        return first, x.grad.numpy()
    got = both(f)
    assert np.asarray(got[1]).reshape(-1)[0] == 5.0


def test_stop_gradient_detach_and_no_grad():
    def f(pkg):
        x = _x(pkg, [1.0, 2.0])
        y = _x(pkg, [3.0, 4.0], sg=True)
        (x * y).sum().backward()
        g1 = x.grad.numpy().copy()
        x.clear_grad()
        z = (x * 2).detach()
        (z * x).sum().backward()
        with pkg.no_grad():
            w = x * 2
        assert w.stop_gradient and y.grad is None and z.stop_gradient
        return g1, x.grad.numpy()
    both(f)


def test_backward_through_getitem_concat_and_topk():
    a = np.random.default_rng(0).standard_normal((3, 2)).astype(np.float32)

    def f(pkg):
        x = pkg.to_tensor(a, stop_gradient=False)
        pkg.concat([x[0:1], x[2:3]], axis=0).sum().backward()
        g = x.grad.numpy().copy()
        v = pkg.to_tensor(np.array([[3.0, 1.0, 2.0]], np.float32),
                          stop_gradient=False)
        vals, _ = pkg.topk(v, 2)
        vals.sum().backward()
        return g, v.grad.numpy()
    both(f)


def test_matmul_and_tanh_grads():
    r = np.random.default_rng(1)
    a = r.standard_normal((3, 4)).astype(np.float32)
    b = r.standard_normal((4, 2)).astype(np.float32)

    def f(pkg):
        x = pkg.to_tensor(a, stop_gradient=False)
        y = pkg.to_tensor(b, stop_gradient=False)
        pkg.tanh(pkg.matmul(x, y)).exp().sum().backward()
        return x.grad.numpy(), y.grad.numpy()
    both(f)


def test_register_hook_scales_the_gradient():
    def f(pkg):
        x = _x(pkg, [1.0, 1.0])
        seen = {}

        def hook(g):
            seen["g"] = g.numpy().copy()
            return g * 2
        h = x.register_hook(hook)
        (x * 3).sum().backward()
        out = [seen["g"], x.grad.numpy().copy()]
        h.remove()
        return out
    both(f)


def test_retain_grads_on_an_intermediate():
    def f(pkg):
        x = _x(pkg, [1.0])
        y = x * 2
        y.retain_grads()
        (y * 3).backward()
        return y.grad.numpy(), x.grad.numpy()
    both(f)


def test_paddle_grad_leaves_dot_grad_alone():
    def f(pkg):
        x = _x(pkg, [2.0])
        y = x * x
        (g,) = pkg.grad(y, x)
        assert x.grad is None
        return g.numpy()
    both(f)


def test_paddle_grad_create_graph_gives_the_second_derivative():
    """The first derivative equals JAX's; the second is held to 6x. The
    JAX tape records no graph for a gradient (its ``create_graph`` gives
    zeros here), so JAX's ``hessian`` transform is the reference."""
    x_np = np.array([2.0, 3.0], np.float32)

    def first(pkg):
        x = _x(pkg, x_np)
        (g,) = pkg.grad((x * x * x).sum(), x, create_graph=True)
        return g.numpy()
    both(first)
    x = _x(pp, x_np)
    (g,) = pp.grad((x * x * x).sum(), x, create_graph=True)
    assert not g.stop_gradient
    (h,) = pp.grad(g.sum(), x)
    jh = jp.autograd.hessian(lambda a: (a * a * a).sum(),
                             jp.to_tensor(x_np)).numpy()
    np.testing.assert_allclose(h.numpy(), jh.sum(0), **TOL)


def test_paddle_grad_unused_input():
    """An input the outputs do not reach: zeros (the JAX package's rule)
    unless ``allow_unused``, then None."""
    def f(pkg):
        x = _x(pkg, [2.0])
        u = _x(pkg, [1.0, 1.0])
        y = x * 3
        g = pkg.grad(y, [x, u], retain_graph=True)
        g2 = pkg.grad(y, [x, u], allow_unused=True)
        assert g2[1] is None
        return g[0].numpy(), g[1].numpy(), g2[0].numpy()
    both(f)


def test_paddle_grad_stops_at_no_grad_vars():
    """``no_grad_vars`` blocks the gradient through them: d(x*x + b)/dx
    with ``b = x * 4`` blocked is 2x. The JAX package takes the argument
    and ignores it, so its reference here is the gradient of the
    expression without the blocked term."""
    x_np = np.array([1.5, -2.0], np.float32)
    x = pp.to_tensor(x_np, stop_gradient=False)
    b = x * 4
    (g,) = pp.grad((x * x + b).sum(), x, no_grad_vars=[b])
    jx = jp.to_tensor(x_np, stop_gradient=False)
    (jg,) = jp.grad((jx * jx).sum(), jx)
    np.testing.assert_allclose(g.numpy(), jg.numpy(), **TOL)


def test_pylayer_custom_backward():
    def f(pkg):
        class Double(pkg.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x, k):
                ctx.save_for_backward(x)
                return x * k

            @staticmethod
            def backward(ctx, grad):
                (saved,) = ctx.saved_tensor
                return grad * 2 + saved * 0

        x = _x(pkg, [1.0, 2.0])
        y = Double.apply(x, 3.0)
        y.sum().backward()
        return y.numpy(), x.grad.numpy()
    both(f)


def test_pylayer_two_outputs_and_saved_tensor_call():
    class Split(pp.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2, x * 3

        @staticmethod
        def backward(ctx, ga, gb):
            (x,) = ctx.saved_tensor()
            return ga * 2 + gb * 3 + x * 0

    x = _x(pp, [1.0, 2.0])
    a, b = Split.apply(x)
    (a + b).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [5.0, 5.0])


def test_functional_transforms():
    xs = np.array([1.0, 2.0, 3.0], np.float32)
    w = np.array([2.0, 2.0, 2.0], np.float32)
    t = np.array([0.0, 1.0, 0.0], np.float32)

    def f(pkg):
        x = pkg.to_tensor(xs)
        h = pkg.autograd.hessian(lambda a: (a ** 3).sum(), x)
        j = pkg.autograd.jacobian(lambda a: a ** 2, x)
        out, g = pkg.autograd.vjp(lambda a: (a ** 3).sum(), x)
        _, tt = pkg.autograd.jvp(lambda a: a * a, x, pkg.to_tensor(t))
        ja, jb = pkg.autograd.jacobian(lambda a, b: a * b,
                                       [x, pkg.to_tensor(w)])
        (ha, hab), (hba, hb) = pkg.autograd.hessian(
            lambda a, b: (a * a * b).sum(), [x, pkg.to_tensor(w)])
        return [h.numpy(), j.numpy(), out.numpy(), g.numpy(), tt.numpy(),
                ja.numpy(), jb.numpy(), ha.numpy(), hab.numpy(),
                hba.numpy(), hb.numpy()]
    both(f)


def test_multi_input_vjp_returns_one_gradient_per_input():
    def f(pkg):
        a = pkg.to_tensor(np.array([1.0, 2.0], np.float32))
        b = pkg.to_tensor(np.array([3.0, 4.0], np.float32))
        _, gs = pkg.autograd.vjp(lambda x, y: (x * y).sum(), [a, b])
        return [g.numpy() for g in gs]
    both(f)


def test_grad_modes():
    assert pp.is_grad_enabled()
    pp.set_grad_enabled(False)
    try:
        x = _x(pp, [1.0])
        assert (x * 2).stop_gradient
    finally:
        pp.set_grad_enabled(True)

    @pp.no_grad()
    def g(t):
        return t * 2
    assert g(_x(pp, [1.0])).stop_gradient
    with pp.no_grad():
        with pp.enable_grad():
            assert not (_x(pp, [1.0]) * 2).stop_gradient


def test_inplace_on_a_leaf_that_requires_grad_rebinds_as_in_jax():
    """torch refuses an in-place op on such a leaf; the facade rebinds
    (the JAX ``_adopt``), so the op is allowed, the tensor holds the new
    values, and a backward through it reaches the original leaf's
    values (the leaf itself is no longer the facade's)."""
    for pkg in (jp, pp):
        x = _x(pkg, [1.0, 2.0])
        x.scale_(3.0)
        np.testing.assert_array_equal(x.numpy(), [3.0, 6.0])
        assert not x.stop_gradient


def test_backward_on_a_tensor_without_grad_is_a_no_op():
    for pkg in (jp, pp):
        x = _x(pkg, [1.0], sg=True)
        (x * 2).sum().backward()
        assert x.grad is None


@pytest.mark.parametrize("pkg", [jp, pp], ids=["jax", "port"])
def test_non_scalar_backward_needs_a_grad_tensor(pkg):
    x = _x(pkg, [1.0, 2.0])
    with pytest.raises(RuntimeError):
        (x * 2).backward()
    (x * 2).backward(pkg.to_tensor(np.array([1.0, 0.5], np.float32)))
    np.testing.assert_array_equal(x.grad.numpy(), [2.0, 1.0])
