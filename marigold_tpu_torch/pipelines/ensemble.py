"""Ensembling of the port, counterpart of `marigold_tpu/pipelines/ensemble.py`:
  * `ensemble_depth`: align E members by scale and shift, reduce them by
    median (uncertainty: MAD) or mean (std), renormalize to [0, 1];
  * `ensemble_normals`: the renormalized mean, or per pixel the member
    closest to it ("closest"); uncertainty = mean arccos / pi;
  * `ensemble_iid`: median/MAD or mean/std per channel.
Layout: members on the leading axis, NCHW, `[E, C, H, W]`.

`gauge_anchor=True` (the serving default) solves the alignment on the
members' device: member 0 is anchored at its initial scale and shift, the
pairwise cost runs on an E x E Gram matrix of the members, and the range
regularizer on a `reg_max_res` nearest copy, as in the JAX package's
`_ensemble_depth_anchored`. The solver is a port of
`jax.scipy.optimize.minimize(method="BFGS")` (`_minimize_bfgs` below) with
gradients from `torch.autograd.grad`. JAX runs its `while_loop`s on the
device; the eager port reads the loop's scalars on the host once per
function evaluation and once per line search (`solve_stats` counts these
syncs).

`gauge_anchor=False` is the reference-exact mode: `reference_alignment_solve`
(numpy + scipy BFGS in float64 with finite-difference gradients, the
reference's own solver) runs on the host by design, between a device prefix
(nearest downsample, initial parameters) and a device suffix (align, reduce,
renormalize), exactly as the JAX package runs it.
"""

from __future__ import annotations

import collections
import math
from typing import Callable, Optional

import numpy as np
import torch

F32 = np.float32
# per-process counters of the device solve: solves, BFGS iterations,
# cost evaluations (value and gradient) and host reads of device scalars
solve_stats: collections.Counter = collections.Counter()


def lower_median(x: torch.Tensor, dim: int = 0, keepdim: bool = True
                 ) -> torch.Tensor:
    """The lower middle value for even counts (torch.median's semantics,
    which the JAX package reproduces with a sort)."""
    return torch.median(x, dim=dim, keepdim=keepdim).values


def _reduce(x: torch.Tensor, reduction: str, return_uncertainty: bool):
    """Reduce axis 0. Returns ([1, ...], uncertainty or None)."""
    uncertainty = None
    if reduction == "mean":
        pred = x.mean(dim=0, keepdim=True)
        if return_uncertainty:
            uncertainty = x.std(dim=0, keepdim=True, unbiased=False)
    elif reduction == "median":
        pred = lower_median(x)
        if return_uncertainty:
            uncertainty = lower_median((x - pred).abs())
    else:
        raise ValueError(f"Unrecognized reduction method: {reduction}.")
    return pred, uncertainty


def nearest_indices(m: int, n: int, device=None) -> torch.Tensor:
    """Source indices of a nearest resize from m to n samples:
    floor((i + 0.5) * m / n) in fp32, as `jax.image.resize(method="nearest")`
    computes them."""
    pos = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * m / n
    return pos.floor().long()


def _downsample_nearest_max_res(x: torch.Tensor, max_res: Optional[int]
                                ) -> torch.Tensor:
    """Nearest downsample of [E, C, H, W] so that max(H, W) <= max_res."""
    h, w = x.shape[-2:]
    m = max(h, w)
    if max_res is None or m <= max_res:
        return x
    scale = max_res / m
    nh, nw = max(1, int(h * scale)), max(1, int(w * scale))
    x = x.index_select(-2, nearest_indices(h, nh, x.device))
    return x.index_select(-1, nearest_indices(w, nw, x.device))


def _init_alignment(flat, m_flat, affine):
    """Initial scale/shift from each member's valid range. Returns
    (x0, init_s, init_t)."""
    if m_flat is not None:
        valid = m_flat > 0
        inf = torch.tensor(float("inf"), dtype=flat.dtype, device=flat.device)
        init_min = torch.where(valid, flat, inf).amin(dim=1)
        init_max = torch.where(valid, flat, -inf).amax(dim=1)
    else:
        init_min = flat.amin(dim=1)
        init_max = flat.amax(dim=1)
    if affine:
        init_s = 1.0 / (init_max - init_min).clamp(min=1e-6)
        init_t = -init_s * init_min
        return torch.cat([init_s, init_t]), init_s, init_t
    init_s = 1.0 / init_max.clamp(min=1e-6)
    return init_s, init_s, None


def _apply_align(d, param, E, scale_invariant, shift_invariant):
    if scale_invariant and shift_invariant:
        return d * param[:E].reshape(E, 1, 1, 1) + param[E:].reshape(E, 1, 1, 1)
    if scale_invariant:
        return d * param.reshape(E, 1, 1, 1)
    return d


def _finalize(pred, uncertainty, mask, scale_invariant, shift_invariant,
              output_uncertainty):
    """Final renormalization to [0, 1] over the valid pixels; members
    neither scale- nor shift-invariant pass through (the JAX package's
    extension for pre-aligned metric members)."""
    if not (scale_invariant or shift_invariant):
        return pred, uncertainty
    affine = scale_invariant and shift_invariant
    if mask is not None:
        inf = torch.tensor(float("inf"), dtype=pred.dtype, device=pred.device)
        d_max = torch.where(mask, pred, -inf).amax()
        d_min = torch.where(mask, pred, inf).amin() if affine else 0.0
    else:
        d_max = pred.max()
        d_min = pred.min() if affine else 0.0
    d_range = (d_max - d_min).clamp(min=1e-6)
    pred = (pred - d_min) / d_range
    if output_uncertainty:
        uncertainty = uncertainty / d_range
    return pred, uncertainty


def _validate_depth_args(depth, reduction, scale_invariant, shift_invariant):
    if depth.ndim != 4 or depth.shape[1] != 1:
        raise ValueError(f"Expecting [E,1,H,W]; got {tuple(depth.shape)}.")
    if reduction not in ("mean", "median"):
        raise ValueError(f"Unrecognized reduction method: {reduction}.")
    if not scale_invariant and shift_invariant:
        raise ValueError("Pure shift-invariant ensembling is not supported.")


# ------------------------------------------------------------------ #
# reference-exact mode (gauge_anchor=False): host scipy solve


def reference_alignment_solve(
    small: np.ndarray,
    m_small: Optional[np.ndarray],
    x0: np.ndarray,
    *,
    affine: bool,
    reduction: str,
    regularizer_strength: float,
    max_iter: int,
    tol: float,
) -> np.ndarray:
    """Reference-exact alignment solve on HOST: the FULL unanchored
    objective minimized by scipy BFGS — float64 parameter vector,
    finite-difference gradients over an fp32 cost — exactly the
    reference's solver semantics (marigold/util/ensemble.py:139-173:
    fp32 maps, per-pair RMS accumulated into a python float, fp64
    params, `tol`/`maxiter` passed straight to scipy). The regularizer
    is evaluated on the same downsampled maps as the pairwise term,
    as the reference does (ensemble.py:146-161). Pure numpy in/out; the
    jitted phases around it live in `ensemble_depth`'s reference path.

    `m_small` (float {0,1} mask, any broadcastable shape, or None)
    restricts every statistic to valid pixels — our shape-bucketing
    extension; the reference has no padding so None is reference-exact.
    """
    import scipy.optimize

    E = small.shape[0]
    d = np.asarray(small, np.float32).reshape(E, -1)
    if m_small is not None:
        valid = np.asarray(m_small).reshape(-1) > 0
        if not valid.all():
            d = d[:, valid]
    iu, ju = np.triu_indices(E, k=1)
    # the pairwise differences, written row by row into one buffer (the
    # values of a[iu] - a[ju] without its two gathered copies), and the
    # median by partition: the same values as a sort, at half the cost
    diff = np.empty((len(iu), d.shape[1]), np.float32)

    def cost(param):
        if affine:
            s = param[:E].astype(np.float32)
            t = param[E:].astype(np.float32)
        else:
            s = param.astype(np.float32)
            t = np.zeros(E, np.float32)
        a = d * s[:, None] + t[:, None]
        for k, (i, j) in enumerate(zip(iu, ju)):
            np.subtract(a[i], a[j], out=diff[k])
        np.multiply(diff, diff, out=diff)
        c = float(np.sum(np.sqrt(np.mean(diff, axis=1, dtype=np.float32))))
        if regularizer_strength > 0:
            if reduction == "median":
                pred = np.partition(a, (E - 1) // 2, axis=0)[(E - 1) // 2]
            else:
                pred = np.mean(a, axis=0)
            c += (abs(float(pred.min()))
                  + abs(1.0 - float(pred.max()))) * regularizer_strength
        return c

    res = scipy.optimize.minimize(
        cost, np.asarray(x0, np.float64), method="BFGS", tol=tol,
        options={"maxiter": max_iter, "disp": False},
    )
    # the reference uses res.x unconditionally; guard only
    # non-finite values (which would poison the whole map).
    x = np.where(np.isfinite(res.x), res.x, np.asarray(x0, np.float64))
    return x.astype(np.float32)


def _ensemble_depth_reference(depth, valid_mask, *, scale_invariant,
                              shift_invariant, output_uncertainty, reduction,
                              regularizer_strength, max_iter, tol, max_res):
    """Device prefix (downsample, init), host scipy solve, device suffix
    (align, reduce, renormalize)."""
    depth = depth.float()
    E = depth.shape[0]
    affine = scale_invariant and shift_invariant
    mask = None
    if valid_mask is not None:
        mask = valid_mask.bool().expand((1,) + depth.shape[1:])
    small = _downsample_nearest_max_res(depth, max_res)
    m_small = (_downsample_nearest_max_res(mask.float(), max_res)
               if mask is not None else None)
    x0, _, _ = _init_alignment(
        small.reshape(E, -1),
        m_small.reshape(1, -1) if m_small is not None else None, affine)
    param = reference_alignment_solve(
        small.cpu().numpy(),
        m_small.cpu().numpy() if m_small is not None else None,
        x0.cpu().numpy(), affine=affine, reduction=reduction,
        regularizer_strength=regularizer_strength, max_iter=max_iter, tol=tol)
    depth = _apply_align(depth, torch.from_numpy(param).to(depth.device), E,
                         scale_invariant, shift_invariant)
    pred, uncertainty = _reduce(depth, reduction, output_uncertainty)
    return _finalize(pred, uncertainty, mask, scale_invariant,
                     shift_invariant, output_uncertainty)


# ------------------------------------------------------------------ #
# BFGS: a port of jax.scipy.optimize.minimize(method="BFGS")
# (jax/_src/scipy/optimize/bfgs.py and line_search.py) in float32. The
# iterate, the gradient and the inverse Hessian stay on the device; the
# line search's scalars (step, value, directional derivative) are read to
# the host as np.float32 and combined there with the same float32
# operations the JAX loops perform on the device.


class _Evaluator:
    """phi(t) = f(x + t p), its derivative and the gradient, one host read
    per evaluation."""

    def __init__(self, fun: Callable[[torch.Tensor], torch.Tensor]):
        self.fun = fun

    def value_and_grad(self, x: torch.Tensor):
        x = x.detach().requires_grad_(True)
        f = self.fun(x)
        (g,) = torch.autograd.grad(f, x)
        solve_stats["evaluations"] += 1
        return f.detach(), g

    def along(self, x: torch.Tensor, p: torch.Tensor, t):
        f, g = self.value_and_grad(x + float(t) * p)
        phi, dphi, ginf = torch.stack(
            [f, torch.dot(g, p), g.abs().max()]).tolist()
        solve_stats["syncs"] += 1
        return F32(phi), F32(dphi), g, F32(ginf)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = np.array([[dc ** 2, -db ** 2], [-dc ** 3, db ** 3]], np.float32)
    d2 = np.array([fb - fa - C * db, fc - fa - C * dc], np.float32)
    A, B = (d1 @ d2) / denom
    radical = B * B - F32(3) * A * C
    return a + (-B + np.sqrt(radical)) / (F32(3) * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (F32(2) * B)


def _zoom(ev, x, p, wolfe_one, wolfe_two, a_lo, phi_lo, dphi_lo, a_hi,
          phi_hi, dphi_hi, g0, ginf0):
    """Algorithm 3.6 of Nocedal & Wright as JAX's `_zoom` runs it. Returns
    (failed, a_star, phi_star, g_star, ginf_star); on failure the star
    values are JAX's initial ones (step 1, phi_lo, g0)."""
    done = failed = False
    a_rec = (a_lo + a_hi) / F32(2)
    phi_rec = (phi_lo + phi_hi) / F32(2)
    star = (F32(1), phi_lo, g0, ginf0)
    j = 0
    while not done and not failed:
        dalpha = a_hi - a_lo
        a, b = min(a_hi, a_lo), max(a_hi, a_lo)
        cchk, qchk = F32(0.2) * dalpha, F32(0.1) * dalpha
        failed = failed or bool(dalpha <= F32(1e-5))
        a_j_cubic = _cubicmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, a_rec,
                              phi_rec)
        use_cubic = j > 0 and a + cchk < a_j_cubic < b - cchk
        a_j_quad = _quadmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi)
        use_quad = not use_cubic and a + qchk < a_j_quad < b - qchk
        if use_cubic:
            a_j = a_j_cubic
        elif use_quad:
            a_j = a_j_quad
        else:
            a_j = (a_lo + a_hi) / F32(2)
        phi_j, dphi_j, g_j, ginf_j = ev.along(x, p, a_j)

        hi_to_j = wolfe_one(a_j, phi_j) or phi_j >= phi_lo
        star_to_j = wolfe_two(dphi_j) and not hi_to_j
        hi_to_lo = (dphi_j * (a_hi - a_lo) >= 0 and not hi_to_j
                    and not star_to_j)
        lo_to_j = not hi_to_j and not star_to_j
        if hi_to_j:
            a_hi, phi_hi, dphi_hi, a_rec, phi_rec = (a_j, phi_j, dphi_j,
                                                     a_hi, phi_hi)
        if star_to_j:
            done = True
            star = (a_j, phi_j, g_j, ginf_j)
        if hi_to_lo:
            a_hi, phi_hi, dphi_hi, a_rec, phi_rec = (a_lo, phi_lo, dphi_lo,
                                                     a_hi, phi_hi)
        if lo_to_j and not hi_to_lo:
            a_rec, phi_rec = a_lo, phi_lo
        if lo_to_j:
            a_lo, phi_lo, dphi_lo = a_j, phi_j, dphi_j
        j += 1
        failed = failed or j >= 30
    return (failed, *star)


def _line_search(ev, x, p, phi0, old_old_fval, g0, ginf0, maxiter):
    """Strong-Wolfe line search (Algorithm 3.5) as JAX's `line_search`
    runs it, c1 = 1e-4, c2 = 0.9. Returns (failed, a_k, f_k, g_k,
    ginf_k)."""
    dphi0 = F32(torch.dot(g0, p).item())
    solve_stats["syncs"] += 1
    cand = F32(2.02) * (phi0 - old_old_fval) / dphi0
    start = F32(1) if cand > 1 else cand

    def wolfe_one(a_i, phi_i):
        return bool(phi_i > phi0 + F32(1e-4) * a_i * dphi0)

    def wolfe_two(dphi_i):
        return bool(abs(dphi_i) <= F32(-0.9) * dphi0)

    done = failed = False
    i = 1
    a_i1, phi_i1, dphi_i1 = F32(0), phi0, dphi0
    star = (F32(0), phi0, g0, ginf0)
    while not done and i <= maxiter and not failed:
        a_i = start if i == 1 else a_i1 * F32(2)
        phi_i, dphi_i, g_i, ginf_i = ev.along(x, p, a_i)
        to_zoom1 = wolfe_one(a_i, phi_i) or (phi_i >= phi_i1 and i > 1)
        to_i = wolfe_two(dphi_i) and not to_zoom1
        to_zoom2 = dphi_i >= 0 and not to_zoom1 and not to_i
        if to_zoom1:
            z_failed, *star = _zoom(ev, x, p, wolfe_one, wolfe_two, a_i1,
                                    phi_i1, dphi_i1, a_i, phi_i, dphi_i, g0,
                                    ginf0)
            done, failed = True, failed or z_failed
        elif to_i:
            done = True
            star = (a_i, phi_i, g_i, ginf_i)
        elif to_zoom2:
            z_failed, *star = _zoom(ev, x, p, wolfe_one, wolfe_two, a_i,
                                    phi_i, dphi_i, a_i1, phi_i1, dphi_i1, g0,
                                    ginf0)
            done, failed = True, failed or z_failed
        i += 1
        a_i1, phi_i1, dphi_i1 = a_i, phi_i, dphi_i
    a_k, f_k, g_k, ginf_k = star
    if abs(a_k) < F32(1e-8):  # JAX's floor on the step in 32-bit mode
        a_k = F32(np.sign(a_k)) * F32(1e-8)
    return failed or not done, a_k, f_k, g_k, ginf_k


def _minimize_bfgs(fun, x0: torch.Tensor, maxiter: int, gtol: float,
                   line_search_maxiter: int = 10):
    """Algorithm 6.1 of Nocedal & Wright as `jax.scipy.optimize.minimize(
    method="BFGS")` runs it: identity initial inverse Hessian, inf-norm
    gradient test against gtol, stop on a line-search failure (after
    taking its step, as JAX does). Returns (x_k, iterations)."""
    ev = _Evaluator(fun)
    d = x0.shape[0]
    eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
    f_k, g_k = ev.value_and_grad(x0)
    f0, ginf, g2 = torch.stack([f_k, g_k.abs().max(), g_k.norm()]).tolist()
    solve_stats["syncs"] += 1
    f_k, ginf = F32(f0), F32(ginf)
    old_old_fval = f_k + F32(g2) / F32(2)
    x_k, h_k = x0, eye
    converged, failed, k = bool(ginf < F32(gtol)), False, 0
    while not converged and not failed and k < maxiter:
        p_k = -(h_k @ g_k)
        failed, a_k, f_kp1, g_kp1, ginf = _line_search(
            ev, x_k, p_k, f_k, old_old_fval, g_k, ginf, line_search_maxiter)
        s_k = float(a_k) * p_k
        y_k = g_kp1 - g_k
        rho_k = torch.reciprocal(torch.dot(y_k, s_k))
        w = eye - rho_k * s_k[:, None] * y_k[None, :]
        h_kp1 = w @ h_k @ w.T + rho_k * s_k[:, None] * s_k[None, :]
        h_k = torch.where(torch.isfinite(rho_k), h_kp1, h_k)
        converged = bool(ginf < F32(gtol))
        k += 1
        x_k, old_old_fval, f_k, g_k = x_k + s_k, f_k, f_kp1, g_kp1
    solve_stats["iterations"] += k
    return x_k, k


# ------------------------------------------------------------------ #
# depth ensembling


def ensemble_depth(
    depth: torch.Tensor,
    scale_invariant: bool = True,
    shift_invariant: bool = True,
    output_uncertainty: bool = False,
    reduction: str = "median",
    regularizer_strength: float = 0.02,
    max_iter: int = 50,
    tol: float = 1e-6,
    max_res: int = 1024,
    reg_max_res: int = 96,
    gauge_anchor: bool = True,
    valid_mask: Optional[torch.Tensor] = None,
):
    """Align and reduce an ensemble of depth maps `depth` [E, 1, H, W] in
    [0, 1] (`marigold_tpu.pipelines.ensemble.ensemble_depth`).

    `valid_mask` ([1, 1, H, W] bool) keeps pixels, such as the /8 edge
    padding, out of every statistic; masked pixels still get reduced values
    for the caller to crop. `gauge_anchor` selects the device solve (True)
    or the reference-exact host solve (False), see the module notes.

    Returns ([1, 1, H, W] in [0, 1], uncertainty [1, 1, H, W] or None)."""
    _validate_depth_args(depth, reduction, scale_invariant, shift_invariant)
    if not gauge_anchor and depth.shape[0] > 1 and (scale_invariant
                                                    or shift_invariant):
        return _ensemble_depth_reference(
            depth, valid_mask, scale_invariant=scale_invariant,
            shift_invariant=shift_invariant,
            output_uncertainty=output_uncertainty, reduction=reduction,
            regularizer_strength=regularizer_strength, max_iter=max_iter,
            tol=tol, max_res=max_res)
    # the solve differentiates through the members' statistics: work on
    # normal tensors even when called under inference_mode
    with torch.inference_mode(False):
        return _ensemble_depth_anchored(
            depth.float().clone(), scale_invariant, shift_invariant,
            output_uncertainty, reduction, regularizer_strength, max_iter,
            tol, max_res, reg_max_res,
            None if valid_mask is None else valid_mask.clone())


def _ensemble_depth_anchored(depth, scale_invariant, shift_invariant,
                             output_uncertainty, reduction,
                             regularizer_strength, max_iter, tol, max_res,
                             reg_max_res, valid_mask):
    """The device solve with member 0 anchored (`_ensemble_depth_anchored`
    of the JAX package, whose notes explain the gauge anchor, the Gram
    statistics and the 96 px regularizer)."""
    E = depth.shape[0]
    affine = scale_invariant and shift_invariant
    mask = None
    if valid_mask is not None:
        mask = valid_mask.bool().expand((1,) + depth.shape[1:])

    if (scale_invariant or shift_invariant) and E > 1:
        small = _downsample_nearest_max_res(depth, max_res)
        m_small = (_downsample_nearest_max_res(mask.float(), max_res)
                   if mask is not None else None)
        flat = small.reshape(E, -1)
        m_flat = m_small.reshape(1, -1) if m_small is not None else None
        x0, init_s, init_t = _init_alignment(flat, m_flat, affine)
        if affine:
            def to_full(free):
                return torch.cat([init_s[:1], free[:E - 1], init_t[:1],
                                  free[E - 1:]])

            x0_free = torch.cat([init_s[1:], init_t[1:]])
        else:
            def to_full(free):
                return torch.cat([init_s[:1], free])

            x0_free = init_s[1:]

        iu, ju = torch.triu_indices(E, E, 1, device=depth.device)
        if m_flat is not None:
            n_valid = m_flat.sum().clamp(min=1.0)
            fm = flat * m_flat
            gram = fm @ fm.T / n_valid
            mean_d = fm.sum(dim=1) / n_valid
        else:
            gram = flat @ flat.T / flat.shape[1]
            mean_d = flat.mean(dim=1)
        g_diag, g_pair = torch.diagonal(gram), gram[iu, ju]
        reg_small = _downsample_nearest_max_res(small, reg_max_res)
        inf = torch.tensor(float("inf"), device=depth.device)
        reg_mask = (_downsample_nearest_max_res(m_small, reg_max_res) > 0
                    if m_small is not None else None)

        def cost_fn(param):
            if affine:
                s, t = param[:E], param[E:]
            else:
                s, t = param, torch.zeros_like(param)
            q = s.square() * g_diag
            u = s * mean_d
            m2 = (q[iu] + q[ju] - 2.0 * s[iu] * s[ju] * g_pair
                  + 2.0 * (t[iu] - t[ju]) * (u[iu] - u[ju])
                  + (t[iu] - t[ju]).square())
            cost = (m2.clamp(min=0.0) + 1e-12).sqrt().sum()
            if regularizer_strength > 0:
                aligned = _apply_align(reg_small, param, E, scale_invariant,
                                       shift_invariant)
                pred, _ = _reduce(aligned, reduction, False)
                if reg_mask is not None:
                    p_min = torch.where(reg_mask, pred, inf).amin()
                    p_max = torch.where(reg_mask, pred, -inf).amax()
                else:
                    p_min, p_max = pred.amin(), pred.amax()
                cost = cost + ((0.0 - p_min).abs() + (1.0 - p_max).abs()
                               ) * regularizer_strength
            return cost

        with torch.enable_grad(), np.errstate(all="ignore"):
            free, _ = _minimize_bfgs(lambda f: cost_fn(to_full(f)), x0_free,
                                     max_iter, tol)
        solve_stats["solves"] += 1
        with torch.no_grad():
            # BFGS can diverge on degenerate inputs: fall back to the init,
            # and keep the solution only where it is no worse than x0
            free = torch.where(torch.isfinite(free), free, x0_free)
            param = to_full(free)
            param = torch.where(cost_fn(param) <= cost_fn(x0), param, x0)
        depth = _apply_align(depth, param, E, scale_invariant,
                             shift_invariant)

    pred, uncertainty = _reduce(depth, reduction, output_uncertainty)
    return _finalize(pred, uncertainty, mask, scale_invariant,
                     shift_invariant, output_uncertainty)


# ------------------------------------------------------------------ #
# normals and IID


def ensemble_normals(normals: torch.Tensor, output_uncertainty: bool = False,
                     reduction: str = "closest"):
    """Ensemble unit normal maps `normals` [E, 3, H, W]. "mean": the mean
    renormalized (norm clipped at 1e-6); "closest": per pixel the member
    with the largest cosine to that mean (the first on a tie).

    Returns ([1, 3, H, W], uncertainty [1, 1, H, W] or None)."""
    if normals.ndim != 4 or normals.shape[1] != 3:
        raise ValueError(f"Expecting [E,3,H,W]; got {tuple(normals.shape)}.")
    if reduction not in ("closest", "mean"):
        raise ValueError(f"Unrecognized reduction method: {reduction}.")
    normals = normals.float()
    mean = normals.mean(dim=0, keepdim=True)
    mean = mean / torch.linalg.vector_norm(mean, dim=1,
                                           keepdim=True).clamp_min(1e-6)
    sim_cos = None
    if output_uncertainty or reduction != "mean":
        sim_cos = (mean * normals).sum(dim=1, keepdim=True).clamp(-1.0, 1.0)
    uncertainty = None
    if output_uncertainty:
        uncertainty = torch.arccos(sim_cos).mean(dim=0, keepdim=True) / math.pi
    if reduction == "mean":
        return mean, uncertainty
    idx = sim_cos.argmax(dim=0, keepdim=True)  # [1, 1, H, W]
    return normals.gather(0, idx.expand(-1, 3, -1, -1)), uncertainty


def ensemble_iid(targets: torch.Tensor, output_uncertainty: bool = False,
                 reduction: str = "median"):
    """Plain median (MAD) or mean (std) of IID targets [E, C, H, W], per
    channel. Returns ([1, C, H, W], [1, C, H, W] or None)."""
    return _reduce(targets.float(), reduction, output_uncertainty)
