"""The L-BFGS direction kernel's wrapper on the CPU (the kernel itself runs
only on the card: tests/test_torch_cuda.py): a tensor the kernel does not
take raises ValueError before any launch or build, and a CPU vector takes
the plain op sequence (``_precondition_by_lbfgs``) with no launch."""

import numpy as np
import pytest
import torch

from tpinn_torch import optimize
from tpinn_torch.kernels import build
from tpinn_torch.kernels import lbfgs_direction as ld
from tpinn_torch.kernels import mlp_bundle as mb
from tpinn_torch.optimize import LBFGSState, _scale_by_lbfgs

torch.set_num_threads(1)


def _state(n=7, m=3, count=4, dtype=torch.float64, seed=0):
    rng = np.random.default_rng(seed)
    st = LBFGSState(torch.zeros(n, dtype=dtype), m)
    st.count = count
    st.params = torch.tensor(rng.normal(size=n), dtype=dtype)
    st.updates = torch.tensor(rng.normal(size=n), dtype=dtype)
    st.diff_params_memory.copy_(torch.tensor(rng.normal(size=(m, n))))
    st.diff_updates_memory.copy_(st.diff_params_memory * 1.5)
    st.weights_memory.copy_(1.0 / (st.diff_params_memory.double()
                                   * st.diff_updates_memory.double()).sum(1))
    x = st.params + torch.tensor(rng.normal(size=n), dtype=dtype)
    g = st.updates + 2.0 * (x - st.params)
    return st, x, g


def _bad_cases():
    """(name, mutate(state, x, g) -> (state, x, g, scale_out))."""
    def set_attr(name, value):
        def f(st, x, g):
            setattr(st, name, value(getattr(st, name)))
            return st, x, g, None
        return f

    return [
        ("float16", lambda st, x, g: (st, x, g.half(), None)),
        ("int64", lambda st, x, g: (st, x, g.long(), None)),
        ("matrix", lambda st, x, g: (st, x, g[None], None)),
        ("empty", lambda st, x, g: (st, x, g[:0], None)),
        ("short_params", lambda st, x, g: (st, x[:-1], g, None)),
        ("params_dtype", lambda st, x, g: (st, x.float(), g, None)),
        ("ring_shape", set_attr("diff_params_memory", lambda t: t[:, :-1])),
        ("ring_dtype", set_attr("diff_updates_memory", lambda t: t.float())),
        ("weights_dtype", set_attr("weights_memory", lambda t: t.float())),
        ("weights_2d", set_attr("weights_memory", lambda t: t[None])),
        ("too_many_slots", set_attr("weights_memory", lambda t: torch.zeros(
            ld.MAX_MEMORY + 1, dtype=torch.float64))),
        ("prev_params_shape", set_attr("params", lambda t: t[:-1])),
        ("prev_updates_dtype", set_attr("updates", lambda t: t.float())),
        ("negative_count", set_attr("count", lambda c: -1)),
        ("ring_strided", set_attr("diff_params_memory",
                                  lambda t: t.t().contiguous().t())),
        ("updates_strided", lambda st, x, g: (
            st, x, torch.stack([g, g], 1)[:, 0], None)),
        ("ring_on_meta", set_attr("diff_updates_memory",
                                  lambda t: t.to("meta"))),
        ("scale_out_dtype", lambda st, x, g: (
            st, x, g, torch.zeros(1, dtype=torch.float32))),
        ("scale_out_shape", lambda st, x, g: (
            st, x, g, torch.zeros(2, dtype=torch.float64))),
        ("cpu", lambda st, x, g: (st, x, g, None)),
    ]


@pytest.mark.parametrize("name,mutate", _bad_cases(),
                         ids=[c[0] for c in _bad_cases()])
def test_wrapper_refuses_what_the_kernel_does_not_take(name, mutate):
    """Each wrong dtype, shape, device or layout raises ValueError, and
    nothing is built or launched; a right set of tensors on the CPU raises
    too (the kernel runs on CUDA tensors only)."""
    st, x, g, scale_out = mutate(*_state())
    before = dict(mb.LAUNCHES)
    built = build.last_build()
    with pytest.raises(ValueError, match="lbfgs_direction"):
        ld.lbfgs_direction(g, x, st.updates, st.params,
                           st.diff_params_memory, st.diff_updates_memory,
                           st.weights_memory, st.count, scale_out=scale_out)
    assert mb.LAUNCHES == before
    assert build.last_build() is built


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("count", [0, 4])
def test_cpu_vector_takes_the_plain_sequence(dtype, count, monkeypatch):
    """``_scale_by_lbfgs`` on a CPU vector calls ``_precondition_by_lbfgs``
    once with the ring's oldest slot, launches nothing, and returns the
    descent direction: the plain product times −1, bit for bit."""
    calls, products = [], []
    inner = optimize._precondition_by_lbfgs

    def spy(*args):
        calls.append(args[-1])
        products.append(inner(*args))
        return products[-1]

    st, x, g = _state(count=count, dtype=dtype)
    st2, _, _ = _state(count=count, dtype=dtype)
    monkeypatch.setattr(optimize, "_precondition_by_lbfgs", spy)
    before = dict(mb.LAUNCHES)
    d = _scale_by_lbfgs(g, st, x)
    d2 = _scale_by_lbfgs(g, st2, x)
    assert calls == [count % 3] * 2
    assert mb.LAUNCHES == before
    assert d.dtype == dtype
    assert torch.equal(d, -1.0 * products[0]) and torch.equal(d, d2)
    assert st.count == count + 1 and st.params is x and st.updates is g
    for a, b in ((st.diff_params_memory, st2.diff_params_memory),
                 (st.diff_updates_memory, st2.diff_updates_memory),
                 (st.weights_memory, st2.weights_memory)):
        assert torch.equal(a, b)
