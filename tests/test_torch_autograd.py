"""The port's imperative autograd (mxnet_tpu_torch.autograd) against the
reference's tape (``mxnet_tpu.autograd``): record/backward with
``grad_req`` write and add, head gradients, ``mark_variables``, ``grad``
with ``create_graph`` (d²(x³)), a custom ``Function``, in-place updates
of variables, and the recording/training flags.

Same numpy inputs in both packages; float32 gradients compared at 1e-5.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

CPU = mx.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)


def both(a):
    return mx.nd.array(a, ctx=CPU), jmx.nd.array(a)


def close(got, ref):
    onp.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), **TOL)


def _f(pkg, x, w):
    """A small graph: reductions, broadcasting, scalars and a unary."""
    y = pkg.nd.tanh(x * w + 0.5) ** 2 - x / 3.0
    return (y.sum(axis=1) * 2.0).mean()


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_backward_write_and_add_across_two_passes(grad_req):
    rng = onp.random.RandomState(0)
    a, b = rng.randn(3, 4), rng.randn(1, 4)
    grads = []
    for pkg in (mx, jmx):
        with (mx.cpu() if pkg is mx else jmx.cpu()):
            x, w = pkg.nd.array(a), pkg.nd.array(b)
        x.attach_grad(grad_req)
        w.attach_grad(grad_req)
        with pkg.autograd.record():
            loss = _f(pkg, x, w)
        loss.backward(retain_graph=True)
        loss.backward()
        grads.append((x.grad, w.grad, loss))
    (gx, gw, lp), (jx, jw, lj) = grads
    close(lp, lj)
    close(gx, jx)
    close(gw, jw)


def test_grad_buffer_identity_and_write_overwrites():
    x, _ = both(onp.arange(4.0))
    x.attach_grad()
    buf = x.grad
    for scale in (2.0, 5.0):
        with mx.autograd.record():
            y = (x * scale).sum()
        y.backward()
        assert x.grad is buf
        onp.testing.assert_array_equal(buf.asnumpy(), onp.full(4, scale))


def test_head_gradients_and_multiple_heads():
    rng = onp.random.RandomState(1)
    a, hg = rng.randn(2, 3), rng.randn(2, 3)
    results = []
    for pkg in (mx, jmx):
        with (mx.cpu() if pkg is mx else jmx.cpu()):
            x, g = pkg.nd.array(a), pkg.nd.array(hg)
        x.attach_grad()
        with pkg.autograd.record():
            y1 = pkg.nd.exp(x)
            y2 = (x * x).sum()
        pkg.autograd.backward([y1, y2], [g, None])
        results.append(x.grad)
    close(*results)


def test_mark_variables_with_explicit_buffers_and_reqs():
    rng = onp.random.RandomState(2)
    a, b = rng.randn(3), rng.randn(3)
    results = []
    for pkg in (mx, jmx):
        with (mx.cpu() if pkg is mx else jmx.cpu()):
            x, w = pkg.nd.array(a), pkg.nd.array(b)
            gx, gw = pkg.nd.ones((3,)), pkg.nd.zeros((3,))
        pkg.autograd.mark_variables([x, w], [gx, gw], ["add", "write"])
        with pkg.autograd.record():
            y = (x * w * w).sum()
        y.backward()
        results.append((gx, gw))
    (gx, gw), (jx, jw) = results
    close(gx, jx)                                 # 1 + w²
    close(gw, jw)


def test_backward_outside_record_raises_in_both():
    for pkg, err in ((mx, MXNetError), (jmx, jmx.MXNetError)):
        with (mx.cpu() if pkg is mx else jmx.cpu()):
            x = pkg.nd.array([1.0, 2.0])
        x.attach_grad()
        y = (x * 2).sum()                         # not recorded
        with pytest.raises(err, match="record"):
            y.backward()


def test_second_order_grad_of_cube():
    """d/dx (d/dx x³) = 6x through grad(create_graph=True).  Positive x
    only: the reference's second derivative of a power with a float
    exponent is NaN at negative x (it carries the exponent's log(x)
    term), where the port gives 6x."""
    a = onp.array([1.5, 0.5, 2.0])
    results = []
    for pkg in (mx, jmx):
        with (mx.cpu() if pkg is mx else jmx.cpu()):
            x = pkg.nd.array(a)
        x.attach_grad()
        with pkg.autograd.record():
            y = x ** 3
            dx = pkg.autograd.grad(y, x, create_graph=True)
        dx.backward()
        results.append((dx, x.grad))
    (dx, g2), (jdx, jg2) = results
    close(dx, jdx)                                # 3x²
    close(g2, jg2)                                # 6x
    onp.testing.assert_allclose(g2.asnumpy(), 6 * a, **TOL)


def test_grad_leaves_buffers_and_rejects_unconnected():
    x, _ = both(onp.array([1.0, 2.0]))
    z, _ = both(onp.array([3.0]))
    x.attach_grad()
    z.attach_grad()
    with mx.autograd.record():
        y = (x * x).sum()
    (g,) = mx.autograd.grad(y, [x], retain_graph=True)
    onp.testing.assert_array_equal(g.asnumpy(), [2.0, 4.0])
    onp.testing.assert_array_equal(x.grad.asnumpy(), [0.0, 0.0])
    with pytest.raises(MXNetError, match="connected"):
        mx.autograd.grad(y, [z])


def _sigmoid_function(pkg):
    class Sigmoid(pkg.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + pkg.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y) * 3.0         # scaled: the custom one ran
    return Sigmoid()


def test_custom_function():
    a = onp.random.RandomState(3).randn(2, 3)
    results = []
    for pkg in (mx, jmx):
        with (mx.cpu() if pkg is mx else jmx.cpu()):
            x = pkg.nd.array(a)
        x.attach_grad()
        with pkg.autograd.record():
            y = _sigmoid_function(pkg)(x * 2.0)
            loss = y.sum()
        loss.backward()
        results.append((y, x.grad))
    (y, g), (jy, jg) = results
    close(y, jy)
    close(g, jg)
    # not recording: forward only, no graph
    out = _sigmoid_function(mx)(mx.nd.array(a, ctx=CPU))
    assert not out._data.requires_grad


def test_inplace_update_keeps_the_variable():
    """``x += …`` rebinds an attached array (torch refuses in-place on a
    leaf that requires grad); outside record it stays a variable, inside
    record the gradient is taken at the value it had before the update
    (the reference's tape delivers that one last), and after the
    backward the updated value is the variable."""
    a = onp.array([1.0, -2.0, 3.0])
    results = []
    for pkg in (mx, jmx):
        with (mx.cpu() if pkg is mx else jmx.cpu()):
            x = pkg.nd.array(a)
        x.attach_grad()
        x += 1.0                                  # not recorded
        with pkg.autograd.record():
            y = (x * x).sum()
        y.backward()
        g1 = x.grad.copy()
        with pkg.autograd.record():
            x *= 2.0                              # recorded
            z = (x * x * x).sum()
        z.backward()
        g2 = x.grad.copy()
        with pkg.autograd.record():
            w = (x * x).sum()
        w.backward()
        results.append((g1, g2, x.grad.copy(), x))
    for got, ref in zip(*results):
        close(got, ref)


def test_recording_and_training_flags():
    ag = mx.autograd
    assert not ag.is_recording() and not ag.is_training()
    with ag.record():
        assert ag.is_recording() and ag.is_training()
        with ag.pause():
            assert not ag.is_recording() and not ag.is_training()
        with ag.predict_mode():
            assert not ag.is_training() and ag.is_recording()
    with ag.record(train_mode=False):
        assert ag.is_recording() and not ag.is_training()
    assert ag.set_recording(True) is False
    assert ag.set_recording(False) is True
    x, _ = both(onp.ones(2))
    x.attach_grad()
    with ag.record():
        with ag.pause():
            y = x * 2.0                           # paused: no graph
        z = (x * 3.0).sum()
    assert not y._data.requires_grad
    z.backward()
    onp.testing.assert_array_equal(x.grad.asnumpy(), [3.0, 3.0])
    with pytest.raises(MXNetError, match="grad_req"):
        ag.mark_variables([x], [x.grad], "sometimes")
