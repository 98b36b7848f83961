"""The port's depth ensembling (marigold_tpu_torch.pipelines.ensemble)
against the JAX package's, fp32 on the CPU.

The cases of tests/test_ensemble.py (depth) and tests/test_ensemble_oracle.py
run through both packages on the same numpy members. Tolerances:
  * the device solve (gauge_anchor=True): the port's BFGS repeats JAX's in
    float32, so on well-conditioned ensembles both land on the same
    parameters up to float32 rounding, which up to 50 iterations amplify;
    maps agree to MAP_ATOL;
  * on degenerate (uncorrelated) members the free scales collapse and the
    two solvers stop at different points of a flat valley: there the port's
    objective may exceed JAX's by at most COST_RTOL;
  * the reference-exact host solve is the same numpy + scipy code in both,
    so its parameters are identical on the same inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import jax.scipy.optimize as jopt
import pytest
import torch

from marigold_tpu.pipelines import ensemble as JE
from marigold_tpu_torch.pipelines import ensemble as TE

MAP_ATOL = 1e-3
COST_RTOL = 1e-4


def _t(x):
    """NHWC numpy [E, H, W, 1] -> the port's [E, 1, H, W] tensor."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _n(x):
    """The port's [1, 1, H, W] -> NHWC numpy."""
    return x.numpy().transpose(0, 2, 3, 1)


def _both(members, **kw):
    """(JAX pred, JAX unc, port pred, port unc) as NHWC numpy."""
    jm = None if kw.get("valid_mask") is None else jnp.asarray(kw["valid_mask"])
    tm = None if kw.get("valid_mask") is None else _t(kw["valid_mask"])
    kw = {k: v for k, v in kw.items() if k != "valid_mask"}
    pj, uj = JE.ensemble_depth(jnp.asarray(members), output_uncertainty=True,
                               valid_mask=jm, **kw)
    pt, ut = TE.ensemble_depth(_t(members), output_uncertainty=True,
                               valid_mask=tm, **kw)
    return np.asarray(pj), np.asarray(uj), _n(pt), _n(ut)


def _make_ensemble(rng, E=6, H=24, W=32, noise=0.01):
    """tests/test_ensemble.py:_make_ensemble."""
    gt = rng.uniform(0.05, 0.95, size=(1, H, W, 1)).astype(np.float32)
    scales = rng.uniform(0.5, 2.0, size=(E, 1, 1, 1)).astype(np.float32)
    shifts = rng.uniform(-0.3, 0.3, size=(E, 1, 1, 1)).astype(np.float32)
    members = gt * scales + shifts + rng.normal(0, noise, (E, H, W, 1))
    return gt, members.astype(np.float32)


def _corr(a, b):
    return np.corrcoef(a.ravel(), b.ravel())[0, 1]


@pytest.mark.parametrize("E,H,W,noise", [(6, 24, 32, 0.01), (5, 24, 24, 0.005),
                                         (5, 24, 24, 0.02)])
def test_alignment_recovers_the_map_like_jax(E, H, W, noise):
    """test_ensemble.py: depth_alignment_recovers_consistent_map,
    cost_not_worse_than_oracle and output_spans_unit_range."""
    gt, members = _make_ensemble(np.random.default_rng(0), E, H, W, noise)
    pj, uj, pt, ut = _both(members)
    np.testing.assert_allclose(pt, pj, atol=MAP_ATOL, rtol=0)
    np.testing.assert_allclose(ut, uj, atol=MAP_ATOL, rtol=0)
    gt_n = (gt - gt.min()) / (gt.max() - gt.min())
    assert _corr(pt, gt_n) > 0.99
    assert ut.mean() < 0.1
    assert abs(pt.max() - 1.0) < 1e-5 and abs(pt.min()) < 1e-6


def test_scale_only_alignment_like_jax():
    rng = np.random.default_rng(1)
    E, H, W = 6, 24, 32
    base = rng.uniform(0.1, 1.0, size=(1, H, W, 1)).astype(np.float32)
    scales = rng.uniform(0.5, 2.0, size=(E, 1, 1, 1)).astype(np.float32)
    members = np.abs(base * scales + rng.normal(0, 0.005, (E, H, W, 1))
                     ).astype(np.float32)
    pj, uj, pt, ut = _both(members, shift_invariant=False)
    np.testing.assert_allclose(pt, pj, atol=MAP_ATOL, rtol=0)
    np.testing.assert_allclose(ut, uj, atol=MAP_ATOL, rtol=0)
    assert pt.min() >= -1e-6 and pt.max() <= 1 + 1e-6
    assert _corr(pt[0, ..., 0], base[0, ..., 0] / base.max()) > 0.99


@pytest.mark.parametrize("reduction", ["median", "mean"])
def test_single_member_and_reductions_like_jax(reduction):
    rng = np.random.default_rng(2)
    d = rng.uniform(0, 1, (1, 8, 8, 1)).astype(np.float32)
    pj, _, pt, _ = _both(d, reduction=reduction)
    np.testing.assert_allclose(pt, (d - d.min()) / (d.max() - d.min()), atol=1e-6)
    np.testing.assert_allclose(pt, pj, atol=1e-6)
    _, members = _make_ensemble(rng, E=4, H=16, W=16)
    pj, uj, pt, ut = _both(members, reduction=reduction)
    np.testing.assert_allclose(pt, pj, atol=MAP_ATOL, rtol=0)
    np.testing.assert_allclose(ut, uj, atol=MAP_ATOL, rtol=0)


def test_lower_median_even_counts():
    x = np.asarray([[4.0], [1.0], [3.0], [2.0]], np.float32)
    got = TE.lower_median(torch.from_numpy(x), dim=0)
    assert float(got[0, 0]) == 2.0 == float(JE.lower_median(jnp.asarray(x))[0, 0])
    y = np.random.default_rng(3).normal(size=(10, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(TE.lower_median(torch.from_numpy(y)).numpy(),
                                  np.asarray(JE.lower_median(jnp.asarray(y))))


def test_masked_padding_equals_cropped_like_jax():
    """test_ensemble.py: ensemble_depth_masked_padding_equals_cropped."""
    rng = np.random.default_rng(0)
    E, H, W, HP, WP = 5, 40, 48, 64, 64
    base = rng.uniform(0.1, 0.9, (H, W, 1)).astype(np.float32)
    members = np.stack([
        np.clip(base * rng.uniform(0.7, 1.3) + rng.uniform(-0.1, 0.1)
                + rng.normal(0, 0.01, base.shape), 0, 1).astype(np.float32)
        for _ in range(E)])
    padded = np.pad(members, ((0, 0), (0, HP - H), (0, WP - W), (0, 0)),
                    mode="edge")
    mask = np.zeros((1, HP, WP, 1), bool)
    mask[:, :H, :W] = True
    _, _, ref_p, ref_u = _both(members)
    pj, uj, pt, ut = _both(padded, valid_mask=mask)
    np.testing.assert_allclose(pt[:, :H, :W], ref_p, atol=5e-3)
    np.testing.assert_allclose(ut[:, :H, :W], ref_u, atol=5e-3)
    assert _corr(pt[:, :H, :W], ref_p) > 0.99999
    np.testing.assert_allclose(pt, pj, atol=MAP_ATOL, rtol=0)
    np.testing.assert_allclose(ut, uj, atol=MAP_ATOL, rtol=0)


@pytest.mark.parametrize("hw,max_res", [((768, 768), 96), ((576, 768), 96),
                                        ((1024, 1024), 96), ((1000, 700), 256)])
def test_nearest_downsample_samples_what_jax_samples(hw, max_res):
    """The regularizer's and max_res's nearest copies take the source pixels
    jax.image.resize(method="nearest") takes (floor((i + 0.5) * m / n))."""
    h, w = hw
    coded = np.arange(h * w, dtype=np.float32).reshape(1, h, w, 1)
    ref = np.asarray(JE._downsample_nearest_max_res(jnp.asarray(coded), max_res))
    got = _n(TE._downsample_nearest_max_res(_t(coded), max_res))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------------ #
# the oracle cases (tests/test_ensemble_oracle.py)


def _oracle_ensemble(rng, E=6, H=160, W=192, noise=0.02):
    """tests/test_ensemble_oracle.py:make_ensemble."""
    yy, xx = np.meshgrid(np.linspace(0, 2.5, H), np.linspace(0, 2.0, W),
                         indexing="ij")
    base = 0.5 + 0.35 * np.sin(yy + 0.3) * np.cos(0.8 * xx) + 0.1 * yy / 2.5
    members = [float(rng.uniform(0.6, 1.6)) * base + float(rng.uniform(-0.25, 0.25))
               + rng.normal(0, noise, size=base.shape) for _ in range(E)]
    return base.astype(np.float32), np.stack(members).astype(np.float32)


def _relerr_to_base(cand, base):
    A = np.stack([cand.ravel(), np.ones(cand.size)], 1)
    coef, *_ = np.linalg.lstsq(A, base.ravel().astype(np.float64), rcond=None)
    fit = (A @ coef).reshape(base.shape)
    return np.mean(np.abs(fit - base) / np.maximum(base, 1e-3))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_metric_like_jax(seed):
    """test_metric_equal_or_better_than_scipy, through both packages: the
    same map up to MAP_ATOL and the same protocol metric bounds."""
    base, members = _oracle_ensemble(np.random.default_rng(seed))
    pj, _, pt, _ = _both(members[..., None])
    np.testing.assert_allclose(pt, pj, atol=MAP_ATOL, rtol=0)
    ours = pt[0, ..., 0].astype(np.float64)
    assert _relerr_to_base(ours, base) < 0.03
    assert _corr(ours, base) > 0.98


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_exact_mode_like_jax(seed):
    """test_reference_exact_mode_matches_scipy, through both packages
    (E=10, 192x256, the full-resolution regularizer pin): the host solve is
    the same code on the same prefix, so the maps agree to fp32 rounding."""
    base, members = _oracle_ensemble(np.random.default_rng(seed), E=10,
                                     H=192, W=256)
    pj, uj, pt, ut = _both(members[..., None], gauge_anchor=False,
                           reg_max_res=1024)
    np.testing.assert_allclose(pt, pj, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ut, uj, atol=1e-5, rtol=0)
    assert _relerr_to_base(pt[0, ..., 0].astype(np.float64), base) < 0.03


def test_reference_alignment_solve_is_the_same_code():
    """gauge_anchor=False: identical parameters from identical inputs. The
    port's cost function builds the JAX one's values in another way (pair
    differences row by row, the median by partition)."""
    rng = np.random.default_rng(5)
    _, members = _oracle_ensemble(rng, E=4, H=40, W=48)
    small = members[:, None]
    mask = np.ones((1, 1, 40, 48), np.float32)
    mask[..., 30:, :] = 0.0
    flat = members.reshape(4, -1)
    x0 = np.concatenate([1.0 / (flat.max(1) - flat.min(1)),
                         -flat.min(1) / (flat.max(1) - flat.min(1))])
    kw = dict(affine=True, reduction="median", regularizer_strength=0.02,
              max_iter=50, tol=1e-6)
    for m in (None, mask):
        np.testing.assert_array_equal(
            TE.reference_alignment_solve(small, m, x0, **kw),
            JE.reference_alignment_solve(small, m, x0, **kw))


@pytest.mark.parametrize("reduction,affine", [("median", True),
                                               ("median", False),
                                               ("mean", True)])
def test_reference_alignment_solve_matches_jax_at_ten_members(reduction, affine):
    """The host cost function builds its pair differences row by row and
    takes the median by partition; the parameters stay identical to the
    JAX package's at E=10 (an even member count: the lower median)."""
    rng = np.random.default_rng(6)
    _, members = _oracle_ensemble(rng, E=10, H=48, W=64)
    flat = members.reshape(10, -1)
    span = flat.max(1) - flat.min(1)
    x0 = (np.concatenate([1.0 / span, -flat.min(1) / span]) if affine
          else 1.0 / span)
    kw = dict(affine=affine, reduction=reduction, regularizer_strength=0.02,
              max_iter=50, tol=1e-6)
    np.testing.assert_array_equal(
        TE.reference_alignment_solve(members[:, None], None, x0, **kw),
        JE.reference_alignment_solve(members[:, None], None, x0, **kw))


# ------------------------------------------------------------------ #
# the solver


def _anchored_cost(members, param, reg=0.02):
    """The anchored objective at param (numpy float64): the pairwise RMS over
    all pixels (which the Gram statistics rewrite exactly) plus the range
    regularizer of the lower median (maps of at most 96 px: no downsample)."""
    E = members.shape[0]
    a = members.astype(np.float64) * param[:E].reshape(E, 1, 1, 1) \
        + param[E:].reshape(E, 1, 1, 1)
    cost = sum(np.sqrt(np.mean((a[i] - a[j]) ** 2) + 1e-12)
               for i in range(E) for j in range(i + 1, E))
    pred = np.sort(a, axis=0)[(E - 1) // 2]
    return cost + (abs(pred.min()) + abs(1.0 - pred.max())) * reg


def test_anchored_objective_no_worse_than_jax(monkeypatch):
    """Uncorrelated members (a degenerate landscape): the two solvers may
    stop at different points, and the port's objective is within COST_RTOL
    of JAX's or below it. The final parameters are the last ones each
    package aligns the full members with."""
    members = np.random.default_rng(6).uniform(0.1, 0.9, (5, 44, 52, 1)
                                               ).astype(np.float32)
    seen = {"jax": [], "port": []}
    j_apply, t_apply = JE._apply_align, TE._apply_align

    def j_spy(d, param, *args):
        jax.debug.callback(lambda p: seen["jax"].append(np.asarray(p)), param,
                           ordered=True)
        return j_apply(d, param, *args)

    def t_spy(d, param, *args):
        seen["port"].append(param.detach().numpy().copy())
        return t_apply(d, param, *args)

    monkeypatch.setattr(JE, "_apply_align", j_spy)
    monkeypatch.setattr(TE, "_apply_align", t_spy)
    pj, uj, pt, ut = _both(members)
    jax.effects_barrier()
    cost_j = _anchored_cost(members, seen["jax"][-1].astype(np.float64))
    cost_t = _anchored_cost(members, seen["port"][-1].astype(np.float64))
    assert cost_t <= cost_j * (1 + COST_RTOL), (cost_t, cost_j)
    assert np.isfinite(pt).all() and np.isfinite(ut).all()
    assert pt.min() >= -1e-6 and pt.max() <= 1 + 1e-6


def test_bfgs_matches_jax_on_a_smooth_function():
    def f(x, lib):
        return (0.5 * lib.sum((x[1:] - x[:-1] ** 2) ** 2)
                + lib.sum((1 - x) ** 2) + 0.1 * lib.sum(x ** 4))

    x0 = np.array([-1.2, 1.0, 0.5, 2.0, -0.3], np.float32)
    ref = jopt.minimize(lambda x: f(x, jnp), jnp.asarray(x0), method="BFGS",
                        options=dict(maxiter=50, gtol=1e-6))
    got, k = TE._minimize_bfgs(lambda x: f(x, torch), torch.from_numpy(x0),
                               50, 1e-6)
    assert k == int(ref.nit)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.x), atol=1e-5)


def test_bfgs_matches_jax_on_the_gram_cost():
    """The pairwise Gram cost of a correlated ensemble (member 0 anchored),
    minimized by both solvers from the same start."""
    _, members = _oracle_ensemble(np.random.default_rng(7), E=6, H=48, W=64)
    E = members.shape[0]
    flat = members.reshape(E, -1).astype(np.float32)
    gram = flat @ flat.T / flat.shape[1]
    mean_d = flat.mean(1)
    s0 = 1.0 / (flat.max(1) - flat.min(1))
    t0 = -s0 * flat.min(1)
    iu, ju = np.triu_indices(E, k=1)

    def cost(free, lib, g, m):
        s = lib.concatenate([lib.asarray(s0[:1]), free[:E - 1]]) \
            if lib is jnp else torch.cat([torch.from_numpy(s0[:1]), free[:E - 1]])
        t = lib.concatenate([lib.asarray(t0[:1]), free[E - 1:]]) \
            if lib is jnp else torch.cat([torch.from_numpy(t0[:1]), free[E - 1:]])
        q = s * s * lib.diagonal(g)
        u = s * m
        m2 = (q[iu] + q[ju] - 2.0 * s[iu] * s[ju] * g[iu, ju]
              + 2.0 * (t[iu] - t[ju]) * (u[iu] - u[ju]) + (t[iu] - t[ju]) ** 2)
        return lib.sum(lib.sqrt(lib.maximum(m2, lib.zeros_like(m2)) + 1e-12))

    x0 = np.concatenate([s0[1:], t0[1:]]).astype(np.float32)
    ref = jopt.minimize(lambda f: cost(f, jnp, jnp.asarray(gram),
                                       jnp.asarray(mean_d)),
                        jnp.asarray(x0), method="BFGS",
                        options=dict(maxiter=50, gtol=1e-6))
    got, _ = TE._minimize_bfgs(
        lambda f: cost(f, torch, torch.from_numpy(gram),
                       torch.from_numpy(mean_d)), torch.from_numpy(x0), 50, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.x), atol=1e-4,
                               rtol=1e-4)
