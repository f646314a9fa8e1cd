"""Flow-matching samplers: Euler, DPM-Solver++ multistep, UniPC multistep.

Port of `flexam_tpu/sampling/flow_match.py`. The schedules and the per-step
linear update coefficients are host-side numpy, copied as they are; the
device-side step is a PyTorch function over those tables.

The notes below are the JAX module's.

Behavioral references:
  * diffusers FlowMatchEulerDiscreteScheduler (the flagship default,
    `config/wan2.2/wan_civitai_5b_FlexAM.yaml:34-42`, used at
    `pipeline_wan2_2_fun_control_FlexAM.py:604-605,931`)
  * `FlexAM/utils/fm_solvers.py` (FlowDPMSolverMultistepScheduler)
  * `FlexAM/utils/fm_solvers_unipc.py` (FlowUniPCMultistepScheduler)

TPU-first redesign: every solver update above is LINEAR in the current
sample and the (converted) model-output history, with scalar coefficients
that depend only on the static sigma schedule and step index. So:

  1. the sigma schedule and ALL per-step update coefficients are computed
     host-side in fp64 numpy (`build_schedule`) — including the multistep
     warmup, lower-order-final, and UniPC predictor/corrector coefficients
     (obtained by probing a scalar transcription of each update formula
     with basis vectors, which is exact for linear maps);
  2. the device-side step is a coefficient gather + FMA, identical at
     every step -> the whole 50-step denoise loop runs as one `lax.scan`
     inside one jit, no host round-trips, no data-dependent control flow.

Faithfully reproduced schedule quirks (DO differ per scheduler):
  * Euler: diffusers re-applies the static shift inside set_timesteps on
    sigmas that were already shifted at __init__ on the min end
    (sigma_max=1.0 stays fixed); `mu` ignored when use_dynamic_shifting
    is false.
  * DPM: the pipeline passes `get_sampling_sigmas(steps, shift)`
    (`fm_solvers.py:22-26`) as custom sigmas and `set_timesteps` shifts
    them AGAIN (`fm_solvers.py:253-259`) — the effective shift is
    f_s(f_s(sigma)) = f_{s^2}(sigma).
  * UniPC: `sigma_min` is exactly 0 (init sigmas end at 0,
    `fm_solvers_unipc.py:108-110`), so the linspace grid hits 0 at the
    (n+1)-th point which is dropped; final sigma appended as 0.
  * Every solver ends on sigma=0, where the DPM/UniPC update collapses to
    x' = x0_pred (h -> inf handled in fp64 on host).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def _shift_sigmas(sigmas: np.ndarray, shift: float) -> np.ndarray:
    return shift * sigmas / (1 + (shift - 1) * sigmas)


def _time_shift(mu: float, sigma_pow: float, t: np.ndarray) -> np.ndarray:
    """Dynamic shifting (`fm_solvers.py:337-339`)."""
    return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma_pow)


def _alpha_lambda(sigma: float) -> Tuple[float, float]:
    alpha = 1.0 - sigma
    with np.errstate(divide="ignore"):
        lam = np.log(alpha) - np.log(sigma)
    return alpha, float(lam)


# ---------------------------------------------------------------------------
# Sigma schedules
# ---------------------------------------------------------------------------

def euler_sigmas(num_steps: int, shift: float, num_train_timesteps: int = 1000,
                 use_dynamic_shifting: bool = False,
                 mu: Optional[float] = None) -> np.ndarray:
    """diffusers FlowMatchEulerDiscreteScheduler schedule, incl. the
    double-shift of sigma_min. Returns sigmas[num_steps + 1] (last = 0)."""
    t = num_train_timesteps
    init_sigmas = np.linspace(1, t, t)[::-1] / t
    if not use_dynamic_shifting:
        init_sigmas = _shift_sigmas(init_sigmas, shift)
    sigma_max, sigma_min = init_sigmas[0], init_sigmas[-1]
    timesteps = np.linspace(sigma_max * t, sigma_min * t, num_steps)
    sigmas = timesteps / t
    if use_dynamic_shifting:
        sigmas = _time_shift(mu, 1.0, sigmas)
    else:
        sigmas = _shift_sigmas(sigmas, shift)
    return np.concatenate([sigmas, [0.0]])


def dpm_sigmas(num_steps: int, shift: float) -> np.ndarray:
    """The pipeline's DPM path: `get_sampling_sigmas` then the re-shift in
    `set_timesteps` (both with the same shift). Returns sigmas[n + 1]."""
    sigma = np.linspace(1, 0, num_steps + 1)[:num_steps]
    sigma = _shift_sigmas(sigma, shift)      # get_sampling_sigmas
    sigma = _shift_sigmas(sigma, shift)      # set_timesteps re-shift
    return np.concatenate([sigma, [0.0]])


def unipc_sigmas(num_steps: int, shift: float,
                 num_train_timesteps: int = 1000) -> np.ndarray:
    """UniPC path: `set_timesteps(n, shift=shift)` with sigma_max =
    f_cfgshift(1 - 1/T) from __init__ and sigma_min = 0; the linspace grid
    is then shifted by the runtime `shift`. Returns sigmas[n + 1]."""
    t = num_train_timesteps
    init = 1.0 - np.linspace(1, 1 / t, t)[::-1]
    init = _shift_sigmas(init, shift)        # __init__ config shift
    sigma_max, sigma_min = init[0], init[-1]  # f_shift(0.999), 0
    sigmas = np.linspace(sigma_max, sigma_min, num_steps + 1)[:num_steps]
    sigmas = _shift_sigmas(sigmas, shift)
    return np.concatenate([sigmas, [0.0]])


# ---------------------------------------------------------------------------
# Scalar transcriptions of the multistep updates (probed for coefficients)
# ---------------------------------------------------------------------------

def _dpm_update_scalar(sigmas, i, order, x, m, solver_type="midpoint"):
    """`fm_solvers.py` first/second/third-order dpmsolver++ updates on
    scalars. m[k] = converted output at step i-k."""
    st, ss0 = sigmas[i + 1], sigmas[i]
    at, lt = _alpha_lambda(st)
    as0, ls0 = _alpha_lambda(ss0)
    h = lt - ls0
    if order == 1:
        # (`fm_solvers.py:457-461`)
        return (st / ss0) * x - at * (np.exp(-h) - 1.0) * m[0]
    ss1 = sigmas[i - 1]
    _, ls1 = _alpha_lambda(ss1)
    h0 = ls0 - ls1
    r0 = h0 / h
    d0 = m[0]
    d1 = (m[0] - m[1]) / r0
    if order == 2:
        # (`fm_solvers.py:552-561`)
        if solver_type == "midpoint":
            return ((st / ss0) * x - at * (np.exp(-h) - 1.0) * d0
                    - 0.5 * at * (np.exp(-h) - 1.0) * d1)
        return ((st / ss0) * x - at * (np.exp(-h) - 1.0) * d0
                + at * ((np.exp(-h) - 1.0) / h + 1.0) * d1)
    ss2 = sigmas[i - 2]
    _, ls2 = _alpha_lambda(ss2)
    h1 = ls1 - ls2
    r1 = h1 / h
    d1_0, d1_1 = (m[0] - m[1]) / r0, (m[1] - m[2]) / r1
    d1 = d1_0 + (r0 / (r0 + r1)) * (d1_0 - d1_1)
    d2 = (1.0 / (r0 + r1)) * (d1_0 - d1_1)
    # (`fm_solvers.py:668-672`)
    return ((st / ss0) * x - at * (np.exp(-h) - 1.0) * d0
            + at * ((np.exp(-h) - 1.0) / h + 1.0) * d1
            - at * ((np.exp(-h) - 1.0 + h) / h ** 2 - 0.5) * d2)


def _unipc_bh(sigmas, i_t, i_s0, order, solver_type="bh2"):
    """Shared R/b system of UniPC B(h) at (sigma_t=sigmas[i_t],
    sigma_s0=sigmas[i_s0]) (`fm_solvers_unipc.py:446-478,571-597`).
    Returns (a_t, sigma ratio, h_phi_1, B_h, rks helper fn)."""
    at, lt = _alpha_lambda(sigmas[i_t])
    _, ls0 = _alpha_lambda(sigmas[i_s0])
    h = lt - ls0
    hh = -h  # predict_x0
    h_phi_1 = np.expm1(hh)
    bh = hh if solver_type == "bh1" else np.expm1(hh)
    return at, h, hh, h_phi_1, bh


def _unipc_p_scalar(sigmas, i, order, x, m, solver_type="bh2"):
    """`multistep_uni_p_bh_update` (`fm_solvers_unipc.py:404-508`) on
    scalars; m[k] = converted output at step i-k (m[0] newest)."""
    st, ss0 = sigmas[i + 1], sigmas[i]
    at, h, hh, h_phi_1, bh = _unipc_bh(sigmas, i + 1, i, order, solver_type)
    rks, d1s = [], []
    for k in range(1, order):
        _, lsk = _alpha_lambda(sigmas[i - k])
        _, ls0 = _alpha_lambda(ss0)
        rk = (lsk - ls0) / h
        rks.append(rk)
        d1s.append((m[k] - m[0]) / rk)
    rks.append(1.0)
    rks = np.array(rks)
    rr, b = [], []
    h_phi_k = h_phi_1 / hh - 1
    fact = 1
    for k in range(1, order + 1):
        rr.append(np.power(rks, k - 1))
        b.append(h_phi_k * fact / bh)
        fact *= k + 1
        h_phi_k = h_phi_k / hh - 1 / fact
    rr = np.stack(rr)
    b = np.array(b)
    if d1s:
        rhos_p = (np.array([0.5]) if order == 2
                  else np.linalg.solve(rr[:-1, :-1], b[:-1]))
        pred = sum(r * d for r, d in zip(rhos_p, d1s))
    else:
        pred = 0.0
    x_t_ = st / ss0 * x - at * h_phi_1 * m[0]
    return x_t_ - at * bh * pred


def _unipc_c_scalar(sigmas, i, order, last_x, m, m_t, solver_type="bh2"):
    """`multistep_uni_c_bh_update` (`fm_solvers_unipc.py:510-626`) on
    scalars at step i: sigma_t=sigmas[i], sigma_s0=sigmas[i-1]; m[k] =
    converted output at step i-1-k; m_t = converted output at step i."""
    st, ss0 = sigmas[i], sigmas[i - 1]
    at, h, hh, h_phi_1, bh = _unipc_bh(sigmas, i, i - 1, order, solver_type)
    rks, d1s = [], []
    for k in range(1, order):
        _, lsk = _alpha_lambda(sigmas[i - 1 - k])
        _, ls0 = _alpha_lambda(ss0)
        rk = (lsk - ls0) / h
        rks.append(rk)
        d1s.append((m[k] - m[0]) / rk)
    rks.append(1.0)
    rks = np.array(rks)
    rr, b = [], []
    h_phi_k = h_phi_1 / hh - 1
    fact = 1
    for k in range(1, order + 1):
        rr.append(np.power(rks, k - 1))
        b.append(h_phi_k * fact / bh)
        fact *= k + 1
        h_phi_k = h_phi_k / hh - 1 / fact
    rr = np.stack(rr)
    b = np.array(b)
    rhos_c = np.array([0.5]) if order == 1 else np.linalg.solve(rr, b)
    corr = sum(r * d for r, d in zip(rhos_c[:-1], d1s)) if d1s else 0.0
    d1_t = m_t - m[0]
    x_t_ = st / ss0 * last_x - at * h_phi_1 * m[0]
    return x_t_ - at * bh * (corr + rhos_c[-1] * d1_t)


# ---------------------------------------------------------------------------
# Coefficient tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScheduleTables:
    """Static schedule + per-step linear-update coefficients.

    Step semantics (K = solver_order, hist[k] = converted output at step
    i-1-k before this step's shift-in):
      m_t    = sample - sigmas[i] * velocity            (conversion; DPM/UniPC)
      x_corr = c_x*x + c_last*last_x + c_mt*m_t + sum_k c_hist[k]*hist[k]
      x_next = p_x*x_corr + p_mt*m_t + sum_k p_hist[k]*hist[k]
      last_x <- x_corr ; hist <- [m_t, hist[:-1]]
    Euler uses the same form with m_t := velocity and no history.
    """

    kind: str
    sigmas: np.ndarray          # [N+1]
    timesteps: np.ndarray       # [N]
    order: int
    c_x: np.ndarray             # [N]
    c_last: np.ndarray          # [N]
    c_mt: np.ndarray            # [N]
    c_hist: np.ndarray          # [N, K]
    p_x: np.ndarray             # [N]
    p_mt: np.ndarray            # [N]
    p_hist: np.ndarray          # [N, K]
    convert: bool               # m_t = x - sigma*v (True) or m_t = v

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)


def _euler_tables(sigmas: np.ndarray, t: int) -> ScheduleTables:
    n = len(sigmas) - 1
    z = np.zeros(n)
    return ScheduleTables(
        kind="euler", sigmas=sigmas, timesteps=sigmas[:-1] * t, order=1,
        c_x=np.ones(n), c_last=z, c_mt=z, c_hist=np.zeros((n, 1)),
        p_x=np.ones(n), p_mt=np.diff(sigmas), p_hist=np.zeros((n, 1)),
        convert=False)


def _probe(update: Callable[..., float], nargs: int) -> np.ndarray:
    """Exact coefficients of a linear map by basis probing."""
    out = np.zeros(nargs)
    for j in range(nargs):
        basis = [0.0] * nargs
        basis[j] = 1.0
        out[j] = update(*basis)
    return out


def _dpm_tables(sigmas: np.ndarray, t: int, solver_order: int,
                solver_type: str) -> ScheduleTables:
    """Per-step order: warmup (lower_order_nums), lower_order_final for
    <15 steps, always first-order at the final step (final_sigmas_type ==
    "zero"; `fm_solvers.py:745-752,778-786`)."""
    n = len(sigmas) - 1
    k = solver_order
    c_x, c_last, c_mt = np.zeros(n), np.zeros(n), np.zeros(n)
    c_hist = np.zeros((n, k))
    p_x, p_mt = np.zeros(n), np.zeros(n)
    p_hist = np.zeros((n, k))
    for i in range(n):
        order = min(solver_order, i + 1)          # warmup
        if i == n - 1:
            order = 1                             # final_sigmas_type zero
        elif n < 15 and i == n - 2:
            order = min(order, 2)                 # lower_order_second
        # x_corr = x (no corrector in DPM)
        c_x[i] = 1.0

        def upd(x, *ms):
            return _dpm_update_scalar(sigmas, i, order, x,
                                      list(ms) + [0.0] * 3, solver_type)

        coef = _probe(upd, 1 + order)
        p_x[i] = coef[0]
        p_mt[i] = coef[1]
        p_hist[i, :order - 1] = coef[2:1 + order]
    return ScheduleTables(
        kind="dpm", sigmas=sigmas, timesteps=sigmas[:-1] * t, order=k,
        c_x=c_x, c_last=c_last, c_mt=c_mt, c_hist=c_hist,
        p_x=p_x, p_mt=p_mt, p_hist=p_hist, convert=True)


def _unipc_tables(sigmas: np.ndarray, t: int, solver_order: int,
                  solver_type: str) -> ScheduleTables:
    """UniPC predictor-corrector with warmup + lower_order_final
    (`fm_solvers_unipc.py:686-737`)."""
    n = len(sigmas) - 1
    k = solver_order
    c_x, c_last, c_mt = np.zeros(n), np.zeros(n), np.zeros(n)
    c_hist = np.zeros((n, k))
    p_x, p_mt = np.zeros(n), np.zeros(n)
    p_hist = np.zeros((n, k))
    lower_order_nums = 0
    prev_order = None
    for i in range(n):
        # corrector at step i uses this_order decided at step i-1
        if i == 0 or prev_order is None:
            c_x[i] = 1.0
        else:
            oc = prev_order

            def updc(last_x, m_t, *ms):
                return _unipc_c_scalar(sigmas, i, oc, last_x,
                                       list(ms) + [0.0] * 3, m_t, solver_type)

            coef = _probe(updc, 2 + oc)
            c_last[i] = coef[0]
            c_mt[i] = coef[1]
            c_hist[i, :oc] = coef[2:2 + oc]

        this_order = min(solver_order, n - i)     # lower_order_final
        this_order = min(this_order, lower_order_nums + 1)

        def updp(x, m_t, *ms):
            return _unipc_p_scalar(sigmas, i, this_order, x,
                                   [m_t] + list(ms) + [0.0] * 3, solver_type)

        coef = _probe(updp, 1 + this_order)
        p_x[i] = coef[0]
        p_mt[i] = coef[1]
        p_hist[i, :this_order - 1] = coef[2:1 + this_order]
        prev_order = this_order
        if lower_order_nums < solver_order:
            lower_order_nums += 1
    return ScheduleTables(
        kind="unipc", sigmas=sigmas, timesteps=sigmas[:-1] * t, order=k,
        c_x=c_x, c_last=c_last, c_mt=c_mt, c_hist=c_hist,
        p_x=p_x, p_mt=p_mt, p_hist=p_hist, convert=True)


def build_schedule(
    scheduler_type: str,
    num_steps: int,
    shift: float = 5.0,
    num_train_timesteps: int = 1000,
    solver_order: int = 2,
    solver_type: Optional[str] = None,
    use_dynamic_shifting: bool = False,
    mu: Optional[float] = None,
) -> ScheduleTables:
    """Build the full static schedule + update tables for one sampler run."""
    t = num_train_timesteps
    if scheduler_type in ("flow_match_euler", "euler"):
        sig = euler_sigmas(num_steps, shift, t, use_dynamic_shifting, mu)
        return _euler_tables(sig, t)
    if scheduler_type in ("flow_dpm", "dpm", "dpm++"):
        sig = dpm_sigmas(num_steps, shift)
        return _dpm_tables(sig, t, solver_order, solver_type or "midpoint")
    if scheduler_type in ("flow_unipc", "unipc"):
        sig = unipc_sigmas(num_steps, shift, t)
        return _unipc_tables(sig, t, solver_order, solver_type or "bh2")
    raise ValueError(f"unknown scheduler_type: {scheduler_type}")


# ---------------------------------------------------------------------------
# Device-side sampler
# ---------------------------------------------------------------------------

def schedule_arrays(tables: ScheduleTables, device="cpu") -> dict:
    """The device-side view of a schedule: fp32 tensors."""
    names = ("sigmas", "timesteps", "c_x", "c_last", "c_mt", "c_hist", "p_x",
             "p_mt", "p_hist")
    return {n: torch.as_tensor(np.asarray(getattr(tables, n)),
                               dtype=torch.float32, device=device)
            for n in names}


def sampler_init_state(x0: torch.Tensor, order: int):
    """state = (x fp32, last_x fp32, hist [order, ...] fp32)."""
    xf = x0.float()
    return (xf, xf, torch.zeros((order,) + tuple(x0.shape),
                                dtype=torch.float32, device=x0.device))


def sampler_step(arrays: dict, convert: bool, state, velocity: torch.Tensor,
                 i: int):
    """One solver step at step index i; returns (new_state, x_next)."""
    x, last_x, hist = state
    v = velocity.float()
    m_t = x - arrays["sigmas"][i] * v if convert else v
    x_corr = (arrays["c_x"][i] * x + arrays["c_last"][i] * last_x
              + arrays["c_mt"][i] * m_t
              + torch.tensordot(arrays["c_hist"][i], hist, dims=1))
    x_next = (arrays["p_x"][i] * x_corr + arrays["p_mt"][i] * m_t
              + torch.tensordot(arrays["p_hist"][i], hist, dims=1))
    hist = torch.cat([m_t[None], hist[:-1]], dim=0)
    return (x_next, x_corr, hist), x_next


def make_sampler(tables: ScheduleTables, device="cpu"):
    """(init_state, step) closures over the tables, as JAX's `make_sampler`:
    `init_state(x0)` and `step(state, velocity, i) -> (state, x_next)`."""
    arrays = schedule_arrays(tables, device)
    order, convert = tables.order, tables.convert

    def init_state(x0: torch.Tensor):
        return sampler_init_state(x0, order)

    def step(state, velocity: torch.Tensor, i: int):
        return sampler_step(arrays, convert, state, velocity, int(i))

    return init_state, step


def add_noise(sample: torch.Tensor, noise: torch.Tensor, sigma):
    """x_t = (1 - sigma) x0 + sigma noise."""
    return (1.0 - sigma) * sample + sigma * noise
