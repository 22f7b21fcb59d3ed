"""The zoom line search of optax 0.2.6 (``optax.scale_by_zoom_linesearch``,
``optax/_src/linesearch.py``) on a flat parameter vector.

It finds a step size η along an update direction u from the parameters w
that satisfies the sufficient decrease (Armijo) criterion

    f(w + η u) ≤ f(w) + c1 η ⟨u, ∇f(w)⟩ + tol

or, close to a minimum, Hager and Zhang's approximate decrease criterion,
together with the small curvature (strong Wolfe) criterion

    |⟨∇f(w + η u), u⟩| ≤ c2 |⟨∇f(w), u⟩| + tol,

in two phases (Nocedal and Wright, Algorithms 3.5 and 3.6): the interval
search grows the trial by ``increase_factor`` until an interval holding an
acceptable step is known, then the zoom narrows it by cubic, quadratic or
bisection steps.  A trial of either phase is one value and gradient.
Without an accepted step after ``max_linesearch_steps`` trials (or once the
interval is below ``interval_threshold`` with a safe step known) the search
takes the best trial that satisfied the decrease criterion, if any.  A
non-finite value counts as outside the domain (its decrease error is inf).

The settings are the ones the JAX package's L-BFGS round gives optax
(tpinn/optimize.py:205-210): at most 30 trials, a first trial of 1
(``initial_guess_strategy="one"``) and optax's defaults for the rest (no
maximal step, ``tol`` 0, ``increase_factor`` 2, ``slope_rtol`` 1e-4,
``curv_rtol`` 0.9, ``approx_dec_rtol`` 1e-6, ``stepsize_precision`` 1e-5);
they are constants here.  The state stays in 0-d tensors on the
parameters' device, in their dtype; the trial count and the phase are host
integers and flags.  After each trial the host reads one small flag tensor
(stop, interval found, final value non-finite) in one transfer, and nothing
else: the step size is never a Python float.  ``verbose`` diagnostics are
not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a; NaN where the radical is negative."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + -(db * db) * v1) / denom
    B = (-(dc * (dc * dc)) * v0 + db * (db * db) * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db * db)
    return a - C / (2.0 * B)


@dataclasses.dataclass
class ZoomLinesearchState:
    """The search's state: host count and phase, the rest device tensors."""

    count: int
    interval_found: bool
    params: torch.Tensor
    updates: torch.Tensor
    stepsize_guess: torch.Tensor
    stepsize: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor
    slope: torch.Tensor
    value_init: torch.Tensor
    slope_init: torch.Tensor
    decrease_error: torch.Tensor
    curvature_error: torch.Tensor
    error: torch.Tensor
    done: torch.Tensor
    failed: torch.Tensor
    low: torch.Tensor
    value_low: torch.Tensor
    slope_low: torch.Tensor
    high: torch.Tensor
    value_high: torch.Tensor
    slope_high: torch.Tensor
    cubic_ref: torch.Tensor
    value_cubic_ref: torch.Tensor
    safe_stepsize: torch.Tensor
    safe_value: torch.Tensor
    safe_grad: torch.Tensor


class ZoomLinesearch:
    """``optax.zoom_linesearch``: ``init`` then ``step`` per trial while
    ``stop`` (read from the flags ``step`` returns) is false; ``run`` does
    both."""

    tol = 0.0
    increase_factor = 2.0
    slope_rtol = 1e-4
    curv_rtol = 0.9
    approx_dec_rtol = 1e-6
    interval_threshold = 1e-5

    def __init__(self, max_linesearch_steps: int = 30):
        self.max_linesearch_steps = int(max_linesearch_steps)

    # -- the criteria --------------------------------------------------------
    def _decrease_error(self, stepsize, value_step, slope_step, value_init,
                        slope_init):
        """The Armijo error, or Hager and Zhang's approximate decrease
        error where the value is within approx_dec_rtol·|f(w)| of f(w),
        whichever is smaller; 0 where satisfied, inf where NaN."""
        err = value_step - value_init - self.slope_rtol * stepsize * slope_init
        approx = slope_step - (2 * self.slope_rtol - 1.0) * slope_init
        delta_values = (value_step - value_init
                        - self.approx_dec_rtol * torch.abs(value_init))
        approx = torch.maximum(approx, delta_values)
        err = torch.minimum(approx, err)
        err = torch.clamp_min(err, 0.0)
        return torch.where(torch.isnan(err), math.inf, err)

    def _curvature_error(self, slope_step, slope_init):
        err = torch.abs(slope_step) - self.curv_rtol * torch.abs(slope_init)
        err = torch.clamp_min(err, 0.0)
        return torch.where(torch.isnan(err), math.inf, err)

    @staticmethod
    def _on_line(vg: ValueAndGrad, params, stepsize, updates):
        value, grad = vg(params + stepsize * updates)
        return value, grad, torch.dot(grad, updates)

    # -- init ----------------------------------------------------------------
    def init(self, updates: torch.Tensor, params: torch.Tensor, *,
             value: torch.Tensor, grad: torch.Tensor) -> ZoomLinesearchState:
        one = torch.ones((), dtype=params.dtype, device=params.device)
        zero = torch.zeros_like(one)
        inf = torch.full_like(one, math.inf)
        false = torch.zeros((), dtype=torch.bool, device=params.device)
        value = value.to(params.dtype)
        slope = torch.dot(updates, grad)
        return ZoomLinesearchState(
            count=0, interval_found=False, params=params, updates=updates,
            stepsize_guess=one, stepsize=zero, value=value, grad=grad,
            slope=slope, value_init=value, slope_init=slope,
            decrease_error=inf, curvature_error=inf, error=inf,
            done=false, failed=false,
            low=zero, value_low=value, slope_low=slope,
            high=zero, value_high=value, slope_high=slope,
            cubic_ref=zero, value_cubic_ref=value,
            safe_stepsize=zero, safe_value=value, safe_grad=grad)

    # -- the two phases ------------------------------------------------------
    def _search_interval(self, st: ZoomLinesearchState, vg: ValueAndGrad):
        """Algorithm 3.5 of Nocedal and Wright: grow the trial until an
        interval holding an acceptable step is found.  Returns the state
        and whether the interval is found (a device flag)."""
        it = st.count
        prev_stepsize, prev_value, prev_slope = st.stepsize, st.value, st.slope
        new_stepsize = (st.stepsize_guess if it == 0
                        else self.increase_factor * prev_stepsize)
        value, grad, slope = self._on_line(vg, st.params, new_stepsize,
                                           st.updates)
        dec = self._decrease_error(new_stepsize, value, slope, st.value_init,
                                   st.slope_init)
        curv = self._curvature_error(slope, st.slope_init)
        error = torch.maximum(dec, curv)

        safe = dec <= self.tol
        safe_stepsize = torch.where(safe, new_stepsize, st.safe_stepsize)
        safe_value = torch.where(safe, value, st.safe_value)
        safe_grad = torch.where(safe, grad, st.safe_grad)

        set_high = dec > 0.0
        if it > 0:
            set_high = set_high | (value >= prev_value)
        set_low = (slope >= 0.0) & ~set_high
        low = torch.where(set_low, new_stepsize, prev_stepsize)
        value_low = torch.where(set_low, value, prev_value)
        slope_low = torch.where(set_low, slope, prev_slope)
        high = torch.where(set_low, prev_stepsize, new_stepsize)
        value_high = torch.where(set_low, prev_value, value)
        slope_high = torch.where(set_low, prev_slope, slope)

        interval_found = set_high | set_low | (error <= self.tol)
        # without a maximal step size, only an accepted trial ends the search
        done = error <= self.tol
        failed = ~done if it + 1 >= self.max_linesearch_steps \
            else torch.zeros_like(done)
        st = dataclasses.replace(
            st, count=it + 1, stepsize=new_stepsize, value=value, grad=grad,
            slope=slope, decrease_error=dec, curvature_error=curv,
            error=error, done=done, failed=failed,
            low=low, value_low=value_low, slope_low=slope_low, high=high,
            value_high=value_high, slope_high=slope_high, cubic_ref=low,
            value_cubic_ref=value_low, safe_stepsize=safe_stepsize,
            safe_value=safe_value, safe_grad=safe_grad)
        return st, interval_found

    def _zoom_into_interval(self, st: ZoomLinesearchState,
                            vg: ValueAndGrad) -> ZoomLinesearchState:
        """Algorithm 3.6 of Nocedal and Wright: narrow the interval by
        cubic, quadratic or bisection steps."""
        it = st.count
        low, value_low, slope_low = st.low, st.value_low, st.slope_low
        high, value_high, slope_high = st.high, st.value_high, st.slope_high

        delta = torch.abs(high - low)
        left = torch.minimum(high, low)
        right = torch.maximum(high, low)
        cubic_chk = 0.2 * delta
        quad_chk = 0.1 * delta
        too_small = delta <= self.interval_threshold

        middle_cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                                 st.cubic_ref, st.value_cubic_ref)
        use_cubic = ((middle_cubic > left + cubic_chk)
                     & (middle_cubic < right - cubic_chk))
        middle_quad = _quadmin(low, value_low, slope_low, high, value_high)
        use_quad = ~use_cubic & ((middle_quad > left + quad_chk)
                                 & (middle_quad < right - quad_chk))
        middle_bisection = (low + high) / 2.0
        use_bisection = ~use_cubic & ~use_quad
        middle = torch.where(use_cubic, middle_cubic, st.cubic_ref)
        middle = torch.where(use_quad, middle_quad, middle)
        middle = torch.where(use_bisection, middle_bisection, middle)

        value, grad, slope = self._on_line(vg, st.params, middle, st.updates)
        dec = self._decrease_error(middle, value, slope, st.value_init,
                                   st.slope_init)
        curv = self._curvature_error(slope, st.slope_init)
        error = torch.maximum(dec, curv)

        update_safe = (dec <= self.tol) & (value < st.safe_value)
        safe_stepsize = torch.where(update_safe, middle, st.safe_stepsize)
        safe_value = torch.where(update_safe, value, st.safe_value)
        safe_grad = torch.where(update_safe, grad, st.safe_grad)

        done = error <= self.tol
        set_high_to_middle = (dec > 0.0) | (value >= value_low)
        set_high_to_low = (slope * (high - low) >= 0.0) & ~set_high_to_middle
        set_low_to_middle = ~set_high_to_middle

        new_high = torch.where(set_high_to_middle, middle, high)
        new_value_high = torch.where(set_high_to_middle, value, value_high)
        new_slope_high = torch.where(set_high_to_middle, slope, slope_high)
        new_high = torch.where(set_high_to_low, low, new_high)
        new_value_high = torch.where(set_high_to_low, value_low,
                                     new_value_high)
        new_slope_high = torch.where(set_high_to_low, slope_low,
                                     new_slope_high)
        new_low = torch.where(set_low_to_middle, middle, low)
        new_value_low = torch.where(set_low_to_middle, value, value_low)
        new_slope_low = torch.where(set_low_to_middle, slope, slope_low)
        # the old high when high moved, else the old low
        moved_high = set_high_to_middle | set_high_to_low
        cubic_ref = torch.where(moved_high, high, low)
        value_cubic_ref = torch.where(moved_high, value_high, value_low)

        presumably_failed = too_small & (safe_stepsize > 0.0)
        if it + 1 >= self.max_linesearch_steps:
            presumably_failed = torch.ones_like(presumably_failed)
        failed = presumably_failed & ~done
        st = dataclasses.replace(
            st, count=it + 1, stepsize=middle, value=value, grad=grad,
            slope=slope, decrease_error=dec, curvature_error=curv,
            error=error, done=done, failed=failed,
            low=new_low, value_low=new_value_low, slope_low=new_slope_low,
            high=new_high, value_high=new_value_high,
            slope_high=new_slope_high, cubic_ref=cubic_ref,
            value_cubic_ref=value_cubic_ref, safe_stepsize=safe_stepsize,
            safe_value=safe_value, safe_grad=safe_grad)
        return st

    @staticmethod
    def _try_safe_step(st: ZoomLinesearchState) -> ZoomLinesearchState:
        """Where the search failed: the safe step (sufficient decrease
        without the curvature criterion) when there is one, or when the
        last trial left the domain (then the safe step may be 0)."""
        use = st.failed & ((st.safe_stepsize > 0.0)
                           | torch.isinf(st.decrease_error))
        return dataclasses.replace(
            st, stepsize=torch.where(use, st.safe_stepsize, st.stepsize),
            value=torch.where(use, st.safe_value, st.value),
            grad=torch.where(use, st.safe_grad, st.grad))

    def step(self, st: ZoomLinesearchState, vg: ValueAndGrad):
        """One trial.  Returns (state, stop, final value non-finite); those
        flags and the phase are read from the device in one transfer."""
        if st.interval_found:
            st = self._zoom_into_interval(st, vg)
            found = torch.ones_like(st.done)
        else:
            st, found = self._search_interval(st, vg)
        st = self._try_safe_step(st)
        stop, nonfinite, found = torch.stack(
            [st.done | st.failed, ~torch.isfinite(st.value), found]).tolist()
        st.interval_found = found
        return st, stop, nonfinite

    def run(self, st: ZoomLinesearchState, vg: ValueAndGrad):
        """Trials until the search stops: (final state, final value
        non-finite)."""
        while True:
            st, stop, nonfinite = self.step(st, vg)
            if stop:
                return st, nonfinite


@dataclasses.dataclass
class ScaleByZoomLinesearchState:
    """``optax.ScaleByZoomLinesearchState`` with its info fields flat."""

    learning_rate: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor
    num_linesearch_steps: int = 0
    decrease_error: torch.Tensor = None
    curvature_error: torch.Tensor = None
    # whether ``value`` is inf or NaN (known on the host): the next
    # iteration evaluates afresh instead of reusing value and grad
    value_nonfinite: bool = True


class ScaleByZoomLinesearch:
    """``optax.scale_by_zoom_linesearch(max_linesearch_steps,
    initial_guess_strategy="one")``: ``update(updates, state, params,
    value=, grad=, value_and_grad_fn=)`` returns the updates scaled by the
    step size found and the new state, whose value and gradient at the new
    parameters the next iteration reuses."""

    def __init__(self, max_linesearch_steps: int = 30):
        self.search = ZoomLinesearch(max_linesearch_steps)

    def init(self, params: torch.Tensor) -> ScaleByZoomLinesearchState:
        one = torch.ones((), dtype=params.dtype, device=params.device)
        return ScaleByZoomLinesearchState(
            learning_rate=one, value=torch.full_like(one, math.inf),
            grad=torch.zeros_like(params))

    def update(self, updates: torch.Tensor, state: ScaleByZoomLinesearchState,
               params: torch.Tensor, *, value: torch.Tensor,
               grad: torch.Tensor, value_and_grad_fn: ValueAndGrad):
        st = self.search.init(updates, params, value=value, grad=grad)
        st, nonfinite = self.search.run(st, value_and_grad_fn)
        new_state = ScaleByZoomLinesearchState(
            learning_rate=st.stepsize, value=st.value, grad=st.grad,
            num_linesearch_steps=st.count, decrease_error=st.decrease_error,
            curvature_error=st.curvature_error, value_nonfinite=nonfinite)
        return st.stepsize * updates, new_state
