"""L-BFGS with an optional strong-Wolfe line search (counterpart of
``bigdl_tpu.optim.lbfgs``; the reference's optim/LBFGS.scala and
optim/LineSearch.scala ``lswolfe``).

The method is closure-based, as in the reference and the JAX package:
``optimize(feval, x)`` with ``feval(x) -> (f, df/dx)``, because the line
search evaluates the objective again and again. The outer iteration and
the line search's decisions run on the host: each bracketing or zoom
step branches on the objective's value, so reading it back per
evaluation is the algorithm, not a stray sync. The parameters are one
flat vector for the method (``torch.cat`` of ``reshape(-1)`` views, in
the order of ``x``: a tensor, a list of tensors, or a dict of them such
as ``dict(model.named_parameters())``); ``feval`` gets and returns them
in ``x``'s structure. The ``(s, y)`` history stays on the device.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from bigdl_tpu_torch.optim.optim_method import OptimMethod

__all__ = ["LBFGS", "strong_wolfe"]


def _flatten(x):
    """``(flat, unflatten)`` for ``x``: a tensor, or lists, tuples and
    dicts of them (dicts in their own key order)."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        leaves.append(node)
        return len(leaves) - 1

    layout = walk(x)
    shapes = [t.shape for t in leaves]
    flat = torch.cat([t.reshape(-1) for t in leaves]) if len(leaves) > 1 \
        else leaves[0].reshape(-1)

    def unflatten(v):
        parts, start = [], 0
        for shape in shapes:
            n = shape.numel()
            parts.append(v[start:start + n].view(shape))
            start += n

        def build(node):
            if isinstance(node, dict):
                return {k: build(e) for k, e in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(build(e) for e in node)
            return parts[node]
        return build(layout)

    return flat, unflatten


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.dot(a, b))


def _cubic_interpolate(x1, f1, g1, x2, f2, g2, bounds=None):
    """Minimizer of the cubic through (x1, f1, g1) and (x2, f2, g2),
    clamped to ``bounds`` (the interval itself by default): the
    interpolation step of lswolfe (LineSearch.scala polyinterp)."""
    if bounds is not None:
        xmin_bound, xmax_bound = bounds
    else:
        xmin_bound, xmax_bound = (x1, x2) if x1 <= x2 else (x2, x1)
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2_square = d1 ** 2 - g1 * g2
    if d2_square >= 0:
        d2 = d2_square ** 0.5
        if x1 <= x2:
            min_pos = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
        else:
            min_pos = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2))
        return min(max(min_pos, xmin_bound), xmax_bound)
    return (xmin_bound + xmax_bound) / 2.0


def strong_wolfe(feval, x, t, d, f, g, gtd, *, c1: float = 1e-4,
                 c2: float = 0.9, tolerance_change: float = 1e-9,
                 max_ls: int = 25):
    """Strong-Wolfe line search with cubic interpolation (lswolfe).

    ``feval(x, t, d) -> (f, g)`` evaluates at ``x + t * d`` (``f`` a
    float, ``g`` a flat tensor). Returns ``(f_new, g_new, t, n_evals)``."""
    d_norm = float(d.abs().max())
    # bracket phase
    f_prev, g_prev, t_prev = f, g, 0.0
    ls_iter = 0
    bracket = None
    f_new, g_new = feval(x, t, d)
    ls_func_evals = 1
    gtd_new = _dot(g_new, d)
    while ls_iter < max_ls:
        if f_new > (f + c1 * t * gtd) or (ls_iter > 1 and f_new >= f_prev):
            bracket = ([t_prev, t], [f_prev, f_new], [g_prev, g_new])
            break
        if abs(gtd_new) <= -c2 * gtd:
            return f_new, g_new, t, ls_func_evals
        if gtd_new >= 0:
            bracket = ([t_prev, t], [f_prev, f_new], [g_prev, g_new])
            break
        min_step = t + 0.01 * (t - t_prev)
        max_step = t * 10
        tmp = t
        t = _cubic_interpolate(t_prev, f_prev, _dot(g_prev, d), t, f_new,
                               gtd_new, bounds=(min_step, max_step))
        f_prev, g_prev, t_prev = f_new, g_new, tmp
        f_new, g_new = feval(x, t, d)
        ls_func_evals += 1
        gtd_new = _dot(g_new, d)
        ls_iter += 1
    if bracket is None:  # max_ls reached while still descending
        return f_new, g_new, t, ls_func_evals

    # zoom phase
    ts, fs, gs = bracket
    insuf_progress = False
    done = False
    low = 0 if fs[0] <= fs[1] else 1
    while ls_iter < max_ls:
        if abs(ts[1] - ts[0]) * d_norm < tolerance_change:
            break
        t = _cubic_interpolate(ts[0], fs[0], _dot(gs[0], d),
                               ts[1], fs[1], _dot(gs[1], d))
        eps = 0.1 * (max(ts) - min(ts))
        if min(max(ts) - t, t - min(ts)) < eps:
            if insuf_progress or t >= max(ts) or t <= min(ts):
                t = max(ts) - eps if abs(t - max(ts)) < abs(t - min(ts)) \
                    else min(ts) + eps
                insuf_progress = False
            else:
                insuf_progress = True
        else:
            insuf_progress = False
        f_new, g_new = feval(x, t, d)
        ls_func_evals += 1
        gtd_new = _dot(g_new, d)
        ls_iter += 1
        if f_new > (f + c1 * t * gtd) or f_new >= fs[low]:
            hi = 1 - low
            ts[hi], fs[hi], gs[hi] = t, f_new, g_new
            low = 0 if fs[0] <= fs[1] else 1
        else:
            if abs(gtd_new) <= -c2 * gtd:
                done = True  # strong Wolfe holds at t: return this point
                break
            if gtd_new * (ts[1 - low] - ts[low]) >= 0:
                ts[1 - low], fs[1 - low], gs[1 - low] = \
                    ts[low], fs[low], gs[low]
            ts[low], fs[low], gs[low] = t, f_new, g_new
            low = 0 if fs[0] <= fs[1] else 1
    if done:
        return f_new, g_new, t, ls_func_evals
    low = 0 if fs[0] <= fs[1] else 1
    return fs[low], gs[low], ts[low], ls_func_evals


class LBFGS(OptimMethod):
    """Limited-memory BFGS (optim/LBFGS.scala:48).

    ``optimize(feval, x)``: ``feval(x) -> (f, df/dx)``, ``x`` a tensor or
    a list or dict of tensors (module docstring). Returns ``(x*, [f
    history])``, ``f_hist[0]`` the first value, as the reference. The
    state (``old_dirs``, ``old_stps``, ``ro``, ``dir``, ``prevGrad``,
    ``Hdiag``, ``stepLen``, ``nIter``, ``funcEval``) persists across
    ``optimize()`` calls, so two calls of N iterations follow one call
    of 2N. ``update`` raises: the method needs a closure, not one
    gradient."""

    def __init__(self, max_iter: int = 20, max_eval: Optional[float] = None,
                 tol_fun: float = 1e-5, tol_x: float = 1e-9,
                 n_correction: int = 100, learning_rate: float = 1.0,
                 line_search: Optional[str] = "strong_wolfe"):
        super().__init__()
        self.max_iter = max_iter
        self.max_eval = max_eval if max_eval is not None \
            else int(max_iter * 1.25)
        self.tol_fun = tol_fun
        self.tol_x = tol_x
        self.n_correction = n_correction
        self.learning_rate = learning_rate
        if line_search not in (None, "strong_wolfe"):
            raise ValueError("line_search must be None or 'strong_wolfe'")
        self.line_search = line_search

    def optimize(self, feval: Callable, x):
        x_flat, unflatten = _flatten(x)

        def feval_flat(xf):
            f, g = feval(unflatten(xf))
            return float(f), _flatten(g)[0]

        st = self.state
        old_dirs: List = st.setdefault("old_dirs", [])   # y_k
        old_stps: List = st.setdefault("old_stps", [])   # s_k
        ro: List = st.setdefault("ro", [])               # 1 / (y . s)
        n_iter_total = st.get("nIter", 0)
        func_evals = st.get("funcEval", 0)

        f, g = feval_flat(x_flat)
        f_hist = [f]
        current_evals = 1
        func_evals += 1

        if float(g.abs().sum()) <= self.tol_fun:
            st["funcEval"] = func_evals
            return unflatten(x_flat), f_hist

        d = st.get("dir", None)
        # re-entry: the first (s, y) pair below uses s = d * t, so t must
        # be the step length taken last call, not the default rate
        t = st.get("stepLen", self.learning_rate)
        g_prev = st.get("prevGrad", None)
        h_diag = st.get("Hdiag", 1.0)

        n_iter = 0
        while n_iter < self.max_iter:
            n_iter += 1
            n_iter_total += 1

            # ---- direction: two-loop recursion over the stored (s, y)
            if n_iter_total == 1 or g_prev is None:
                d = -g
                h_diag = 1.0
            else:
                y = g - g_prev
                s = d * t
                ys = _dot(y, s)
                if ys > 1e-10:
                    if len(old_dirs) == self.n_correction:
                        old_dirs.pop(0)
                        old_stps.pop(0)
                        ro.pop(0)
                    old_dirs.append(y)
                    old_stps.append(s)
                    ro.append(1.0 / ys)
                    h_diag = ys / _dot(y, y)
                k = len(old_dirs)
                q = -g
                al = [0.0] * k
                for i in range(k - 1, -1, -1):
                    al[i] = _dot(old_stps[i], q) * ro[i]
                    q = q - al[i] * old_dirs[i]
                r = q * h_diag
                for i in range(k):
                    be = _dot(old_dirs[i], r) * ro[i]
                    r = r + (al[i] - be) * old_stps[i]
                d = r
            g_prev, f_prev_iter = g, f

            # ---- step size
            gtd = _dot(g, d)
            if gtd > -self.tol_x:
                break  # not a descent direction
            if n_iter_total == 1:
                t = min(1.0, 1.0 / float(g.abs().sum())) \
                    * self.learning_rate
            else:
                t = self.learning_rate

            if self.line_search == "strong_wolfe":
                def ls_feval(xf, tt, dd):
                    return feval_flat(xf + tt * dd)
                f, g, t, ls_evals = strong_wolfe(
                    ls_feval, x_flat, t, d, f, g, gtd)
                x_flat = x_flat + t * d
                current_evals += ls_evals
                func_evals += ls_evals
            else:
                x_flat = x_flat + t * d
                f, g = feval_flat(x_flat)
                current_evals += 1
                func_evals += 1
            f_hist.append(f)

            # ---- stopping checks (LBFGS.scala order)
            if float(g.abs().sum()) <= self.tol_fun:
                break
            if current_evals >= self.max_eval:
                break
            if float((d * t).abs().sum()) <= self.tol_x:
                break
            if abs(f - f_prev_iter) < self.tol_fun:
                break

        st.update({"dir": d, "prevGrad": g_prev, "Hdiag": h_diag,
                   "stepLen": t, "nIter": n_iter_total,
                   "funcEval": func_evals})
        return unflatten(x_flat), f_hist

    def init_state(self, params):
        return {}

    def update(self, grads, state, params, lr):
        raise NotImplementedError(
            "LBFGS is closure-based (optimize(feval, x)) like the "
            "reference optim/LBFGS.scala; use it with full-batch feval")
