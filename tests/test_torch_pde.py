"""Torch port, the pseudo-spectral steppers on the CPU: Burgers,
Kuramoto-Sivashinsky, 2-D Navier-Stokes and the split-step NLSE
(``fft_wgpu_tpu_torch.models.{burgers,ks,navier_stokes,nlse}``).

The same numpy inputs, made from a seed, go through the JAX package on the
CPU and through the port on CPU tensors: one step and a short rollout of
each stepper, batched, with ``keep_every`` for KS and NLSE, at 1e-5
relative L2.  Beside them the oracles of the JAX package's own tests at
their bars (``tests/test_burgers.py``:
Cole-Hopf 1e-4; ``test_ks.py``: the float64 ETDRK4 1e-4, one step 1e-5
max-abs; ``test_navier_stokes.py``: Taylor-Green 1e-4; ``test_nlse.py``:
the soliton 2e-4, the free Gaussian 1e-4, the trap 5e-4, mass 2e-4), on
the short horizons of those tests, not their 2000-4000-step runs.
"""

import jax
import numpy as np
import pytest
import torch

from fft_wgpu_tpu.models import burgers as j_burgers
from fft_wgpu_tpu.models import ks as j_ks
from fft_wgpu_tpu.models import navier_stokes as j_ns
from fft_wgpu_tpu.models import nlse as j_nlse
from fft_wgpu_tpu_torch import models
from fft_wgpu_tpu_torch.models import navier_stokes as ns

torch.set_num_threads(1)

TOL = 1e-5
CPU = torch.device("cpu")


def _t(x):
    # a CPU tensor asks the port for the CPU
    return torch.from_numpy(np.array(x))


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _c(pair):
    return _np(pair[0]).astype(np.float64) + 1j * _np(pair[1]).astype(np.float64)


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def rrand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------- #
# Burgers
# ---------------------------------------------------------------------- #
def test_burgers_step_and_rollout_match_jax(assert_close):
    n, nu, dt = 256, 0.02, 1e-3
    c, cj = models.burgers_init(n, nu, dt, device=CPU), j_burgers.burgers_init(n, nu, dt)
    assert c.device == CPU and c["visc"].dtype == torch.float32
    u0 = np.asarray(j_burgers.random_initial_condition(jax.random.PRNGKey(0), n, batch=3))
    ur, ui = rrand(1, 3, n // 2 + 1), rrand(2, 3, n // 2 + 1)
    got = models.burgers_step(c, _t(ur), _t(ui))
    want = jax.jit(lambda a, b: j_burgers.burgers_step(cj, a, b))(ur, ui)
    assert_close(_c(got), _c(want), tol=TOL, what="burgers_step")
    assert_close(_np(models.burgers_rollout(c, _t(u0), 20)),
                 np.asarray(j_burgers.burgers_rollout(cj, u0, 20)), tol=TOL, what="rollout")


def test_burgers_cole_hopf_exact(assert_close):
    """u = -2 nu phi_x / phi with phi = 1 + eps e^{-nu t} cos x is an
    exact solution; the RK2 stepper must track it to O(dt^2)."""
    n, nu, eps, t_end, steps = 256, 0.1, 0.8, 1.0, 200
    c = models.burgers_init(n, nu, t_end / steps, device=CPU)
    u0 = models.cole_hopf_solution(n, nu, eps, 0.0, device=CPU)
    assert_close(_np(u0), np.asarray(j_burgers.cole_hopf_solution(n, nu, eps, 0.0)), tol=1e-7)
    want = models.cole_hopf_solution(n, nu, eps, t_end, device=CPU)
    assert_close(_np(models.burgers_rollout(c, u0, steps)), _np(want), tol=1e-4,
                 what="Cole-Hopf")


def test_burgers_dt_convergence():
    """Halving dt must shrink the Cole-Hopf error ~4x (2nd order)."""
    n, nu, eps, t_end = 128, 0.4, 0.9, 2.0
    want = _np(models.cole_hopf_solution(n, nu, eps, t_end, device=CPU))

    def err(steps):
        c = models.burgers_init(n, nu, t_end / steps, device=CPU)
        u0 = models.cole_hopf_solution(n, nu, eps, 0.0, device=CPU)
        return _rel(_np(models.burgers_rollout(c, u0, steps)), want)

    assert err(16) < err(8) / 3.0
    assert err(64) < err(32) / 3.0


def test_burgers_random_fields_dissipate():
    """Batched GRF rollout: shape preserved, energy decays, mean stays 0."""
    n, batch = 256, 4
    c = models.burgers_init(n, 0.02, 1e-3, device=CPU)
    u0 = models.random_initial_condition(torch.Generator().manual_seed(0), n, batch=batch,
                                         device=CPU)
    again = models.random_initial_condition(torch.Generator().manual_seed(0), n, batch=batch,
                                            device=CPU)
    assert u0.shape == (batch, n) and torch.equal(u0, again)
    u1 = models.burgers_rollout(c, u0, 100)
    assert u1.shape == (batch, n)
    assert bool(((u1 * u1).sum(-1) < (u0 * u0).sum(-1)).all())  # viscous dissipation
    assert np.allclose(_np(u1).mean(axis=-1), 0.0, atol=1e-5)
    assert np.allclose(_np(u0).mean(axis=-1), 0.0, atol=1e-6)


# ---------------------------------------------------------------------- #
# Kuramoto-Sivashinsky
# ---------------------------------------------------------------------- #
def _ks_ref(u0, length, h, steps):
    """f64 numpy ETDRK4 reference (Kassam & Trefethen 2005, kursiv.m)."""
    n = u0.shape[-1]
    v = np.fft.fft(u0.astype(np.float64), axis=-1)
    k = 2.0 * np.pi / length * np.fft.fftfreq(n, 1.0 / n)
    lin = k * k - k ** 4
    E = np.exp(h * lin)
    E2 = np.exp(h * lin / 2.0)
    m = 32
    r = np.exp(1j * np.pi * (np.arange(1, m + 1) - 0.5) / m)
    zr = h * lin[:, None] + r[None, :]
    Q = h * np.real(np.mean(np.expm1(zr / 2.0) / zr, axis=1))
    f1 = h * np.real(np.mean(
        (-4.0 - zr + np.exp(zr) * (4.0 - 3.0 * zr + zr ** 2)) / zr ** 3, axis=1))
    f2 = h * np.real(np.mean(
        (2.0 + zr + np.exp(zr) * (-2.0 + zr)) / zr ** 3, axis=1))
    f3 = h * np.real(np.mean(
        (-4.0 - 3.0 * zr - zr ** 2 + np.exp(zr) * (4.0 - zr)) / zr ** 3, axis=1))
    dealias = (np.abs(np.fft.fftfreq(n, 1.0 / n)) <= n / 3.0).astype(float)
    g = -0.5j * k * dealias

    def N(v):
        u = np.real(np.fft.ifft(v, axis=-1))
        return g * np.fft.fft(u * u, axis=-1)

    v = v * dealias
    for _ in range(steps):
        nv = N(v)
        a = E2 * v + Q * nv
        na = N(a)
        b = E2 * v + Q * na
        nb = N(b)
        c = E2 * a + Q * (2.0 * nb - nv)
        nc = N(c)
        v = E * v + f1 * nv + 2.0 * f2 * (na + nb) + f3 * nc
    return np.real(np.fft.ifft(v, axis=-1))


def test_ks_step_and_rollout_match_jax_and_float64(assert_close):
    n, length, h = 128, 32.0 * np.pi, 0.25
    c, cj = models.ks_init(n, length, h, device=CPU), j_ks.ks_init(n, length, h)
    for key in ("k", "mask", "E", "E2", "Q", "f1", "f2", "f3"):
        np.testing.assert_array_equal(_np(c[key]), np.asarray(cj[key]), err_msg=key)
    vr, vi = rrand(3, 2, n // 2 + 1), rrand(4, 2, n // 2 + 1)
    assert_close(_c(models.ks_step(c, _t(vr), _t(vi))),
                 _c(jax.jit(lambda a, b: j_ks.ks_step(cj, a, b))(vr, vi)), tol=TOL,
                 what="ks_step")
    u0 = _np(models.kt_initial_condition(n, length, device=CPU))
    np.testing.assert_array_equal(u0, np.asarray(j_ks.kt_initial_condition(n, length)))
    got = _np(models.ks_rollout(c, _t(u0), 20))
    assert_close(got, np.asarray(j_ks.ks_rollout(cj, u0, 20)), tol=TOL, what="rollout")
    assert_close(got, _ks_ref(u0, length, h, 20), tol=1e-4, what="vs float64 ETDRK4")


def test_ks_trajectory_sampling_and_batch(assert_close):
    n, length, h = 128, 16.0 * np.pi, 0.25
    c, cj = models.ks_init(n, length, h, device=CPU), j_ks.ks_init(n, length, h)
    u0 = np.stack([_np(models.kt_initial_condition(n, length, device=CPU))] * 3)
    u0 = u0 * np.array([1.0, 0.9, 1.1], np.float32)[:, None]
    final, traj = models.ks_rollout(c, _t(u0), 40, keep_every=10)
    assert final.shape == (3, n) and traj.shape == (4, 3, n)
    np.testing.assert_allclose(_np(traj[-1]), _np(final), rtol=0, atol=1e-6)
    jf, jt = j_ks.ks_rollout(cj, u0, 40, keep_every=10)
    assert_close(_np(final), np.asarray(jf), tol=TOL, what="keep_every final")
    assert_close(_np(traj), np.asarray(jt), tol=TOL, what="keep_every trajectory")
    # batch rows evolve independently: row 0 matches a solo rollout
    solo = _np(models.ks_rollout(c, _t(u0[0]), 40))
    np.testing.assert_allclose(_np(final[0]), solo, atol=1e-5)
    with pytest.raises(ValueError, match="multiple of keep_every"):
        models.ks_rollout(c, _t(u0), 41, keep_every=10)


def test_ks_single_step_and_mean_conserved():
    n, length = 128, 32.0 * np.pi
    c = models.ks_init(n, length, 0.1, device=CPU)
    u0 = _np(models.kt_initial_condition(n, length, device=CPU))
    ref = _ks_ref(u0, length, 0.1, 1)
    assert np.max(np.abs(_np(models.ks_rollout(c, _t(u0), 1)) - ref)) < 1e-5
    # t = 25 at h = 1/4: the k = 0 mode has no tendency, the field stays O(1)
    u = _np(models.ks_rollout(models.ks_init(n, length, 0.25, device=CPU), _t(u0), 100))
    assert abs(u.mean() - u0.mean()) < 1e-3
    assert 0.5 < np.sqrt((u ** 2).mean()) < 5.0


# ---------------------------------------------------------------------- #
# 2-D Navier-Stokes
# ---------------------------------------------------------------------- #
def test_ns2d_step_and_batched_rollout_match_jax(assert_close):
    n, nu, dt = 64, 1e-3, 5e-3
    c, cj = models.ns2d_init(n, nu, dt, device=CPU), j_ns.ns2d_init(n, nu, dt)
    for key in ("kx", "ky", "ksq_safe", "mask", "visc"):
        assert_close(_np(c[key]), np.asarray(cj[key]), tol=1e-7, what=key)
    wr, wi = rrand(5, 2, n, n // 2 + 1), rrand(6, 2, n, n // 2 + 1)
    assert_close(_c(models.ns2d_step(c, _t(wr), _t(wi))),
                 _c(jax.jit(lambda a, b: j_ns.ns2d_step(cj, a, b))(wr, wi)), tol=TOL,
                 what="ns2d_step batched")
    w0 = rrand(7, 3, n, n)  # a batch of three fields
    got = models.ns2d_rollout(c, _t(w0), 5)
    assert got.shape == (3, n, n)
    assert_close(_np(got), np.asarray(j_ns.ns2d_rollout(cj, w0, 5)), tol=TOL, what="rollout")
    # each field of the batch alone
    assert_close(_np(got[1]), _np(models.ns2d_rollout(c, _t(w0[1]), 5)), tol=TOL,
                 what="batch row 1 alone")


def test_ns2d_split_transforms_round_trip(assert_close):
    x = rrand(8, 2, 32, 32)
    Xr, Xi = ns._rfft2_split(_t(x))
    assert_close(_np(Xr) + 1j * _np(Xi), np.fft.rfft2(x.astype(np.float64)), tol=TOL)
    assert_close(_np(ns._irfft2_split(Xr, Xi, 32)), x, tol=TOL)


def test_taylor_green_exact_decay(assert_close):
    n, nu, dt, steps, k = 64, 0.02, 0.01, 50, 2
    c = models.ns2d_init(n, nu, dt, device=CPU)
    w0 = models.taylor_green_vorticity(n, k, device=CPU)
    np.testing.assert_array_equal(_np(w0), np.asarray(j_ns.taylor_green_vorticity(n, k)))
    want = _np(w0) * np.exp(-2.0 * k * k * nu * dt * steps)
    assert_close(_np(models.ns2d_rollout(c, w0, steps)), want, tol=1e-4,
                 what="Taylor-Green decay")


def test_ns2d_stays_bounded_and_keeps_its_mean():
    n = 64
    w0 = rrand(9, n, n)
    w0 = w0 - w0.mean()  # zero-mean vorticity
    wT = _np(models.ns2d_rollout(models.ns2d_init(n, nu=1e-3, dt=5e-3, device=CPU),
                                 _t(w0), 20))
    assert np.all(np.isfinite(wT))
    # enstrophy must not grow (viscous, dealiased, unforced)
    assert float(np.sum(wT * wT)) <= float(np.sum(w0 ** 2)) * 1.01
    # the k = 0 mode is invariant
    w1 = rrand(10, 32, 32)
    wT = _np(models.ns2d_rollout(models.ns2d_init(32, nu=5e-3, dt=1e-2, device=CPU),
                                 _t(w1), 10))
    assert abs(float(wT.mean()) - float(w1.mean())) < 1e-5


# ---------------------------------------------------------------------- #
# NLSE / Gross-Pitaevskii
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,length", [((256,), 40.0), ((32, 64), (12.0, 20.0))])
def test_nlse_step_and_rollout_match_jax(shape, length, assert_close):
    dt = 2e-3
    V = 0.05 * rrand(11, *shape) ** 2
    c = models.nlse_init(shape, length, dt, g=1.0, potential=V, device=CPU)
    cj = j_nlse.nlse_init(shape, length, dt, g=1.0, potential=V)
    ur, ui = rrand(12, 2, *shape, scale=0.5), rrand(13, 2, *shape, scale=0.5)
    assert_close(_c(models.nlse_step(c, _t(ur), _t(ui))),
                 _c(jax.jit(lambda a, b: j_nlse.nlse_step(cj, a, b))(ur, ui)), tol=TOL,
                 what=f"nlse_step {shape}")
    # a complex field as it lies, and a (re, im) pair of numpy arrays
    psi = _t(ur + 1j * ui)
    got = models.nlse_rollout(c, psi, 10)
    want = j_nlse.nlse_rollout(cj, (ur, ui), 10)
    assert_close(_c(got), _c(want), tol=TOL, what=f"rollout {shape}")
    (fr, fi), (tr, ti) = models.nlse_rollout(c, (_t(ur), _t(ui)), 10, keep_every=5)
    (jfr, jfi), (jtr, jti) = j_nlse.nlse_rollout(cj, (ur, ui), 10, keep_every=5)
    assert tr.shape == ti.shape == (2, 2, *shape)
    assert_close(_c((fr, fi)), _c((jfr, jfi)), tol=TOL, what="keep_every final")
    assert_close(_c((tr, ti)), _c((jtr, jti)), tol=TOL, what="keep_every trajectory")
    np.testing.assert_array_equal(_np(tr[-1]), _np(fr))


def test_nlse_standing_soliton_and_trajectory(assert_close):
    # v = 0 soliton: |psi| static, global phase exp(i eta^2 t / 2)
    n, L, dt, steps = 256, 40.0, 1e-3, 1000
    c = models.nlse_init((n,), L, dt, g=1.0, device=CPU)
    psi0 = models.bright_soliton(n, L, eta=1.0, device=CPU)
    j0 = j_nlse.bright_soliton(n, L, eta=1.0)
    np.testing.assert_array_equal(_np(psi0[0]), np.asarray(j0[0]))
    np.testing.assert_array_equal(_np(psi0[1]), np.asarray(j0[1]))
    want = _c(models.bright_soliton(n, L, eta=1.0, t=steps * dt, device=CPU))
    assert_close(_c(models.nlse_rollout(c, psi0, steps)), want, tol=2e-4, what="soliton")
    # sampled every 25 steps; step by step equals the rollout
    (fr, _), (tr, ti) = models.nlse_rollout(c, psi0, 100, keep_every=25)
    assert tr.shape == (4, n) and ti.shape == (4, n)
    ur, ui = psi0
    for _ in range(25):
        ur, ui = models.nlse_step(c, ur, ui)
    np.testing.assert_allclose(_np(ur), _np(tr[0]), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="multiple of keep_every"):
        models.nlse_rollout(c, psi0, 30, keep_every=25)


def test_nlse_free_gaussian_and_trap(assert_close):
    # linear case: split-step is exact in time
    n, L = 512, 60.0
    x = (np.arange(n) - n / 2) * (L / n)
    c = models.nlse_init((n,), L, 2e-3, g=0.0, device=CPU)
    got = models.nlse_rollout(c, models.free_gaussian([x], sigma=2.0, device=CPU), 500)
    want = _c(models.free_gaussian([x], sigma=2.0, t=1.0, device=CPU))
    assert_close(_c(got), want, tol=1e-4, what="free Gaussian 1-D")
    n2, L2 = 64, 30.0
    x2 = (np.arange(n2) - n2 / 2) * (L2 / n2)
    c2 = models.nlse_init((n2, n2), L2, 5e-3, g=0.0, device=CPU)
    psi2 = models.free_gaussian([x2, x2], sigma=2.5, device=CPU)
    j2 = j_nlse.free_gaussian([x2, x2], sigma=2.5)
    np.testing.assert_array_equal(_np(psi2[0]), np.asarray(j2[0]))
    want2 = _c(models.free_gaussian([x2, x2], sigma=2.5, t=0.5, device=CPU))
    assert_close(_c(models.nlse_rollout(c2, psi2, 100)), want2, tol=1e-4,
                 what="free Gaussian 2-D")
    # harmonic trap V = x^2/2: the ground state is stationary up to exp(-i t/2)
    n3, L3 = 256, 30.0
    x3 = (np.arange(n3) - n3 / 2) * (L3 / n3)
    c3 = models.nlse_init((n3,), L3, 1e-3, g=0.0, potential=(0.5 * x3 * x3).astype(np.float32),
                          device=CPU)
    psi3 = (_t(np.exp(-x3 * x3 / 2).astype(np.float32)), torch.zeros(n3))
    want3 = np.exp(-x3 * x3 / 2) * np.exp(-1j * 0.5)
    assert_close(_c(models.nlse_rollout(c3, psi3, 1000)), want3, tol=5e-4, what="trap")


def test_nlse_mass_conserved_and_batched(assert_close):
    n, L = 256, 30.0
    c = models.nlse_init((n,), L, 2e-3, g=-1.0, device=CPU)  # defocusing
    re, im = rrand(14, n, scale=0.3), rrand(15, n, scale=0.3)
    psi = _c(models.nlse_rollout(c, (_t(re), _t(im)), 500))
    m0 = np.sum(np.abs(re.astype(np.float64) + 1j * im) ** 2)
    assert abs(np.sum(np.abs(psi) ** 2) - m0) / m0 < 2e-4
    # leading batch dims: each row as alone (the plain path's matmuls round a
    # batch of two and one row differently: 1e-5 relative L2, not bits)
    n, L = 128, 20.0
    c = models.nlse_init((n,), L, 1e-3, g=1.0, device=CPU)
    s1 = models.bright_soliton(n, L, eta=1.0, device=CPU)
    s2 = models.bright_soliton(n, L, eta=0.7, v=0.5, device=CPU)
    br, _ = models.nlse_rollout(c, (torch.stack([s1[0], s2[0]]), torch.stack([s1[1], s2[1]])), 50)
    r1, _ = models.nlse_rollout(c, s1, 50)
    assert_close(_np(br[0]), _np(r1), tol=TOL, what="batch row 0 alone")


def test_nlse_init_errors():
    with pytest.raises(ValueError, match="lengths must match shape rank"):
        models.nlse_init((16, 16), (1.0, 2.0, 3.0), 1e-3, device=CPU)
    with pytest.raises(ValueError, match="1-D and 2-D grids supported"):
        models.nlse_init((8, 8, 8), 1.0, 1e-3, device=CPU)


# ---------------------------------------------------------------------- #
# devices
# ---------------------------------------------------------------------- #
def test_steppers_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    # the plans and the analytic fields go to the current CUDA device by
    # default, and raise with none; numpy input goes to the plan's device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: models.burgers_init(64, 0.1, 1e-3),
                 lambda: models.ks_init(64, 10.0, 0.1),
                 lambda: models.ns2d_init(32, 0.01, 0.01),
                 lambda: models.nlse_init((64,), 10.0, 1e-3),
                 lambda: models.cole_hopf_solution(64, 0.1, 0.5, 0.0),
                 lambda: models.kt_initial_condition(64, 10.0),
                 lambda: models.taylor_green_vorticity(32),
                 lambda: models.bright_soliton(64, 10.0),
                 lambda: models.free_gaussian([np.arange(8.0)], 1.0),
                 lambda: models.random_initial_condition(torch.Generator(), 64)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    c = models.burgers_init(64, 0.1, 1e-3, device="cpu")
    u = models.burgers_rollout(c, np.sin(np.arange(64) * 2 * np.pi / 64).astype(np.float32), 2)
    assert u.device.type == "cpu" and u.dtype == torch.float32
