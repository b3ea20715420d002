"""Vectorized batched-kill nested sampler
(port of ``nestfit_tpu/sampling/sampler.py``: the segmented and the
traced mode, and every ``NSConfig`` knob).

A batch of R independent nested-sampling runs (one per pixel) advances
in lockstep.  Each fill-cycle kills the ``kill_k`` worst live points of a
run and replaces them with draws above the frozen threshold, first from
a multi-ellipsoid rejection proposal (the candidate regime), then, once
its acceptance collapses, from whitened multi-chain slice sampling (the
kill+slice regime).  In the segmented mode a host loop switches between
the two, probes for a switch back, and compacts straggler runs; the
traced mode (``segment_iters=0``) repeats one block of ``block_iters``
candidate iterations and a masked slice fill until every run is done
(``graphs.py`` captures the block as a CUDA graph on the card, and each
unit of the segmented loop too).  The JAX
package documents the algorithm and its measured choices; this module
keeps its structure so the two can be read side by side.

What differs from the JAX package, by design:

* Every ``lax.while_loop`` is a Python loop whose condition reads the
  ``[R]`` done mask on the host.  The iteration counter ``i`` is a host
  integer, so the bound-refresh ``lax.cond`` becomes a Python ``if``.
* The traced mode's candidate iterations do not stop when every run is
  done: a block always runs its ``block_iters`` masked iterations, which
  then change nothing a caller reads, and the host reads the done mask
  once per block.
* The shrinkage loop of a slice step runs a fixed number of masked rounds
  (``ceil(max_contract / spec_width)``) instead of stopping when every
  lane has accepted: the extra rounds change nothing a caller reads and
  save a host sync per round.
* Randomness comes from one ``torch.Generator``; its stream differs from
  ``jax.random``, so sampler parity is statistical.
* ``jnp.linalg.cholesky`` returns NaN for a matrix that is not positive
  definite; :func:`_chol` reproduces that with ``cholesky_ex``.
* Large per-run buffers (``dead_u``/``dead_lnl``) are updated in place:
  the host loop never reuses a state it passed on (the JAX package
  donates it).
* No operation of an iteration waits for the host: masked scatters
  write their dropped entries to a spare column or back onto themselves
  instead of compacting by a boolean mask, and the constant tables are
  built once per device, so an iteration can be captured in a graph.
* The mesh is an argument (``run_nested(..., mesh=)``), not ambient: each
  dp row runs its share of the runs in a thread of its own, on its own
  device and generator, in either mode (``parallel/mesh.py``).
"""

import dataclasses
import math
import os
import threading
import time
from typing import Callable

import numpy as np
import torch

from nestfit_tpu_torch.utils.profiling import count, span, to_host

_NEG = -1e30  # sentinel for log-zero; avoids inf-inf NaNs in f32

#: the segmented host loop's progress lines (MultiNest's ``fb`` feedback),
#: read once at import as in the JAX package; the traced mode prints none
_NS_DEBUG = bool(os.environ.get("NESTFIT_NS_DEBUG"))


@dataclasses.dataclass(frozen=True)
class NSConfig:
    """Nested sampling knobs; the same names, defaults and meaning as the
    JAX package's ``NSConfig`` (see its field comments)."""

    nlive: int = 100
    tol: float = 1.0              # remaining-evidence termination (dlogz)
    max_iter: int = 0             # max deaths per run; 0 -> auto
    method: str = "auto"          # "auto", "ellipsoid" or "slice"
    kill_k: int = 0               # points killed per fill-cycle; 0 -> auto
    cand_factor: int = 2          # proposal candidates per kill slot
    n_clusters: int = 3           # bounding ellipsoids per run
    km_iters: int = 4             # Lloyd iterations for the clustering
    km_refine: int = 3            # Mahalanobis-reassignment rounds
    cluster_vol_frac: float = 0.7  # coverage guard for the cluster set
    cube_redraws: int = 4         # redraw rounds for out-of-cube draws
    bound_every: int = 4          # iterations between bound recomputes
    flat_dims: tuple = ()         # likelihood-flat unit-cube dims
    pwrap_dims: tuple = ()        # periodic unit-cube dims (pWrap)
    block_iters: int = 8          # candidate iterations per slice fill
    cand_min_acc: float = 0.0     # regime-switch threshold; 0 -> auto
    switch_iters: int = 16        # candidate segment length in "auto"
    switch_back: bool = True      # two-way regime switch
    switch_back_margin: float = 1.3
    switch_back_every: int = 64   # slice iterations between probes
    slice_bound_every: int = 1    # whitening refresh cadence (slice)
    stall_limit: int = 64         # zero-fill iterations before abandon
    n_repeats: int = 0            # slice steps for method="slice"
    max_contract: int = 6         # shrinkage proposals per slice step
    spec_width: int = 2           # speculative proposals per launch
    cov_reg: float = 1e-10        # covariance diagonal regularizer
    ell_fudge: float = 1.05       # ellipsoid enlargement
    efr: float = 0.0              # MultiNest efr: ellipsoid volume x 1/efr
    ceff: bool = False            # constant-efficiency mode
    dir_mode: str = "diff"        # slice directions: gauss/diff/mix
    fallback_repeats: int = 0     # slice steps per fill chain; 0 -> auto
    log_zero: float = -1e90       # MultiNest logZero floor (off below -1e60)
    init_factor: int = 1          # oversampled-init multiplier
    init_stratified: bool = True  # Latin-hypercube initial live set
    init_chunk: int = 32          # live-point chunk for the init evals
    min_compact: int = 64         # smallest compacted batch

    def __post_init__(self):
        if self.method not in ("auto", "ellipsoid", "slice"):
            raise ValueError(f"unknown method {self.method!r}")

    def resolved(self, ndim: int) -> "NSConfig":
        max_iter = self.max_iter if self.max_iter > 0 \
            else 120 * self.nlive + self.n_init_dead()
        n_repeats = self.n_repeats if self.n_repeats > 0 else 2 * ndim
        if self.fallback_repeats > 0:
            fallback = self.fallback_repeats
        else:
            fallback = max(2, min(ndim // 2, max(3, ndim // 3)))
            if ndim >= 8:
                fallback = max(fallback, 4)
        if self.method == "slice":
            kill_k = 1
        elif self.kill_k > 0:
            kill_k = min(self.kill_k, self.nlive // 2)
        else:
            frac = 2 if ndim <= 6 else 4
            kill_k = max(1, self.nlive // frac)
        return dataclasses.replace(
            self, max_iter=max_iter, n_repeats=n_repeats, kill_k=kill_k,
            fallback_repeats=fallback,
        )

    def n_cand(self) -> int:
        """Proposal candidates per iteration (requires resolved cfg)."""
        return max(1, self.cand_factor * self.kill_k)

    def n_init_dead(self) -> int:
        """Deaths recorded by the oversampled-init kill-down phase."""
        return max(0, (self.init_factor - 1) * self.nlive)


def _weight_tables(nlive: int, kill_k: int, max_iter: int,
                   n_init_dead: int = 0):
    """Static per-death compression tables ``LNX[max_iter + 1]`` (ln
    volume after t deaths) and ``LNW[max_iter]`` (ln volume element of
    death t), as in the JAX package."""
    n_init_dead = min(n_init_dead, max_iter)
    L0 = nlive + n_init_dead
    d_init = 1.0 / (L0 - np.arange(n_init_dead))
    n_main = max_iter - n_init_dead
    d_main = 1.0 / (nlive - (np.arange(n_main) % kill_k))
    d = np.concatenate([d_init, d_main])
    lnx = np.concatenate([[0.0], -np.cumsum(d)])
    lnw = lnx[:-1] + np.log1p(-np.exp(-d))
    return lnx, lnw


#: per-run fields of :class:`_State` (leading axis R)
_RUN_FIELDS = ("u", "lnl", "lnl_shift", "lnz", "done", "converged",
               "n_deaths", "pending", "thresh", "zombie", "stall", "ncall",
               "dead_u", "dead_lnl", "ceff_mult")


@dataclasses.dataclass
class _State:
    gen: torch.Generator       # one stream; draws are batched over R
    u: torch.Tensor            # [R, L, D] live points (unit cube)
    lnl: torch.Tensor          # [R, L] shifted ln-likelihoods
    lnl_shift: torch.Tensor    # [R] per-run shift (initial live max)
    lnz: torch.Tensor          # [R] shifted accumulated evidence
    done: torch.Tensor         # [R] bool
    converged: torch.Tensor    # [R] bool
    n_deaths: torch.Tensor     # [R] int32
    pending: torch.Tensor      # [R] int32 kill slots awaiting replacement
    thresh: torch.Tensor       # [R] frozen acceptance threshold (shifted)
    zombie: torch.Tensor       # [R, L] slots holding recorded-dead points
    stall: torch.Tensor        # [R] int32 consecutive zero-fill iterations
    ncall: torch.Tensor        # [R] int32 likelihood evaluations
    dead_u: torch.Tensor       # [R, max_iter, D]
    dead_lnl: torch.Tensor     # [R, max_iter]
    i: int                     # iteration counter (host copy)
    bounds: tuple              # cached bounding geometry
    acc_ema: torch.Tensor      # 0-d EMA of candidate acceptance
    ceff_mult: torch.Tensor    # [R] ceff volume multiplier (1 unless ceff)


@dataclasses.dataclass(frozen=True)
class NSResult:
    """Raw output of a batch of runs; lnL arrays are unshifted and
    entries beyond ``n_dead`` are masked to ``-1e30``."""

    lnz: torch.Tensor
    lnz_err: torch.Tensor
    h: torch.Tensor
    lnl_shift: torch.Tensor
    n_dead: torch.Tensor
    ncall: torch.Tensor
    converged: torch.Tensor
    dead_u: torch.Tensor
    dead_lnl: torch.Tensor
    dead_lnw: torch.Tensor
    live_u: torch.Tensor
    live_lnl: torch.Tensor
    live_lnw: torch.Tensor
    max_loglike: torch.Tensor
    nlive: int
    ndim: int
    max_iter: int

    @property
    def n_samples(self):
        return self.n_dead + self.nlive


def _rand(gen, shape, like):
    return torch.rand(shape, generator=gen, device=like.device,
                      dtype=like.dtype)


def _randn(gen, shape, like):
    return torch.randn(shape, generator=gen, device=like.device,
                       dtype=like.dtype)


def _put(dst, rows, cols, vals, ok):
    """``dst`` ``[R, N, ...]`` with ``dst[rows, cols] = vals`` where
    ``ok``, out of place: JAX's ``.at[rows, cols].set(vals, mode="drop")``.
    Dropped entries go to a spare column N, so ``cols`` may repeat where
    ``ok`` is False, and nothing waits for the host."""
    N = dst.shape[1]
    pad = torch.cat([dst, dst[:, :1]], dim=1)
    pad[rows, torch.where(ok, cols, N)] = vals
    return pad[:, :N]


def _put_inplace(dst, rows, cols, vals, ok):
    """``dst[rows, cols] = vals`` where ``ok``, in place, for a buffer
    too large to copy; every ``(rows, cols)`` pair must be distinct, and
    the entries not ``ok`` write back what they read."""
    keep = ok if vals.ndim == ok.ndim else ok[..., None]
    dst[rows, cols] = torch.where(keep, vals, dst[rows, cols])


def _chol(cov):
    """Cholesky factor; NaN where ``cov`` is not positive definite, as
    ``jnp.linalg.cholesky`` returns (``torch.linalg.cholesky`` raises)."""
    L, info = torch.linalg.cholesky_ex(cov)
    return torch.where((info == 0)[..., None, None], L, math.nan)


def _tri_solve(chol, b):
    """``solve_triangular(chol, b, lower=True)`` for ``b[..., D, K]``."""
    return torch.linalg.solve_triangular(chol, b, upper=False)


def _wrap_vec(cfg: NSConfig, ndim: int, like):
    """``[D]`` bool mask of the periodic dims on ``like``'s device, or
    None when ``cfg.pwrap_dims`` is empty (the default path stays free
    of wrap operations)."""
    if not cfg.pwrap_dims:
        return None
    key = ("wrap", tuple(cfg.pwrap_dims), ndim, like.device)
    if key not in _CONSTS:
        m = np.zeros((ndim,), dtype=bool)
        m[np.asarray(cfg.pwrap_dims, dtype=np.int64)] = True
        _CONSTS[key] = torch.as_tensor(m, device=like.device)
    return _CONSTS[key]


def _wrap_pts(x, wrap):
    """Wrap the periodic dims of cube points into [0, 1)."""
    if wrap is None:
        return x
    return torch.where(wrap, x - torch.floor(x), x)


def _recenter(u, wrap):
    """The periodic dims of the live matrix ``u`` ``[R, L, D]`` in
    universal-cover coordinates around each run's circular mean, so the
    bounding geometry sees a seam-split cloud as one compact cloud (see
    the JAX package)."""
    if wrap is None:
        return u
    two_pi = 2.0 * np.pi
    ang = u * two_pi
    theta = torch.atan2(torch.mean(torch.sin(ang), dim=1),
                        torch.mean(torch.cos(ang), dim=1)) / two_pi
    d = u - theta[:, None, :]
    d = d - torch.round(d)
    return torch.where(wrap, theta[:, None, :] + d, u)


def _line_bracket(x, dirv, z, nvec, rmax, wrap=None):
    """Slice bracket: the t-interval of ``x + t * dirv`` inside both the
    global bounding ellipsoid (whitened ``z + t * nvec``, radius
    ``rmax``) and the unit cube; t = 0 always inside.  Periodic dims
    (``wrap``) have no cube walls."""
    big = 1e30
    a = torch.sum(nvec**2, dim=-1)
    b = 2.0 * torch.sum(z * nvec, dim=-1)
    c = torch.sum(z**2, dim=-1) - rmax**2
    disc = torch.sqrt(torch.clamp(b * b - 4.0 * a * c, min=0.0))
    a2 = torch.clamp(2.0 * a, min=1e-30)
    te_lo = (-b - disc) / a2
    te_hi = (-b + disc) / a2
    eps = 1e-12
    pos = dirv > eps
    neg = dirv < -eps
    safe = torch.where(pos | neg, dirv, 1.0)
    t_hi_d = torch.where(pos, (1.0 - x) / safe,
                         torch.where(neg, (0.0 - x) / safe, big))
    t_lo_d = torch.where(neg, (1.0 - x) / safe,
                         torch.where(pos, (0.0 - x) / safe, -big))
    if wrap is not None:
        t_hi_d = torch.where(wrap, big, t_hi_d)
        t_lo_d = torch.where(wrap, -big, t_lo_d)
    t_lo = torch.maximum(te_lo, torch.amax(t_lo_d, dim=-1))
    t_hi = torch.minimum(te_hi, torch.amin(t_hi_d, dim=-1))
    return torch.clamp(t_lo, max=0.0), torch.clamp(t_hi, min=0.0)


def _shrink_slice(loglike2, data, shift, gen, x0, lnl0, dirv, t_lo0,
                  t_hi0, lnl_star, done, cfg, wrap=None):
    """Shrinkage-only slice step from an analytic bracket, with
    ``cfg.spec_width`` speculative proposals per likelihood launch (see
    the JAX package).  Returns ``(x, lnl, t_acc, acc, ncall)``; ``ncall``
    counts only the evaluations the sequential algorithm consumes.
    Periodic dims (``wrap``) stay in universal-cover coordinates and are
    wrapped into the cube only for the likelihood.

    Runs the full ``ceil(max_contract / W)`` rounds: once a lane has
    accepted, later rounds change nothing for it."""
    W = max(1, min(cfg.spec_width, cfg.max_contract))
    n_rounds = (cfg.max_contract + W - 1) // W
    budget = cfg.max_contract

    def pt(t):
        xr = x0 + t[..., None] * dirv
        xp = torch.clamp(xr, 0.0, 1.0)
        if wrap is not None:
            xp = torch.where(wrap, xr, xp)
        return xp

    t_lo, t_hi, x, lnl = t_lo0, t_hi0, x0, lnl0
    t_acc = torch.zeros_like(lnl_star)
    acc = torch.zeros_like(lnl_star, dtype=torch.bool)
    ncall = torch.zeros_like(lnl_star, dtype=torch.int32)
    for j in range(n_rounds):
        # the whole speculative chain prefix: proposal w's bracket is
        # the bracket after rejecting proposals 0..w-1
        tl, th = t_lo, t_hi
        ts, wbs = [], []
        for w in range(W):
            wb = (j * W + w) < budget
            t = tl + (th - tl) * _rand(gen, lnl_star.shape, lnl_star)
            ts.append(t)
            wbs.append(wb)
            if wb:
                tl = torch.where(t < 0, t, tl)
                th = torch.where(t >= 0, t, th)
        stack = torch.stack([pt(t) for t in ts], dim=0)
        lnlp = loglike2(_wrap_pts(stack, wrap).reshape(
            (-1,) + x0.shape[1:]), data).reshape(
            (W,) + lnl_star.shape) - shift
        live0 = ~(done | acc)
        taken = torch.zeros_like(acc)
        for w in range(W):
            if not wbs[w]:
                continue
            new = (lnlp[w] > lnl_star) & ~acc & ~taken
            x = torch.where(new[..., None], pt(ts[w]), x)
            lnl = torch.where(new, lnlp[w], lnl)
            t_acc = torch.where(new, ts[w], t_acc)
            ncall = ncall + (live0 & ~taken).to(torch.int32)
            taken = taken | new
        acc = acc | taken
        miss = ~acc
        t_lo = torch.where(miss, tl, t_lo)
        t_hi = torch.where(miss, th, t_hi)
    return x, lnl, t_acc, acc, ncall


def _whiten(chol, du):
    """Whitened coords of ``du`` [C, R, D] under ``chol`` [R, D, D]."""
    return _tri_solve(chol, du.permute(1, 2, 0)).permute(2, 0, 1)


def _slice_chains(gen, loglike2, data, shift, x, z, lnl_x, thr_b, dead_b,
                  chol, rmax, act, n_rep, cfg, u_all=None, order=None,
                  n_surv=None, wrap=None):
    """Advance ``[C, R]`` whitened slice chains by ``n_rep`` repeats;
    returns ``(x, lnl_x, ncall[R], moved[C, R])``.  Directions follow
    ``cfg.dir_mode`` ("gauss", "diff" survivor differences, or "mix")."""
    C, R, D = x.shape
    mode = cfg.dir_mode
    if mode != "gauss" and (u_all is None or order is None
                            or n_surv is None):
        mode = "gauss"
    rr = torch.arange(R, device=x.device)

    def gauss_dir():
        nvec = _randn(gen, (C, R, D), x) * act
        return nvec, torch.einsum("rde,cre->crd", chol, nvec)

    def diff_dir():
        ns = torch.clamp(n_surv, min=2)[None, :].long()       # [1, R]
        ia = torch.randint(0, 1 << 30, (C, R), generator=gen,
                           device=x.device) % ns
        ib = torch.randint(0, 1 << 30, (C, R), generator=gen,
                           device=x.device) % ns
        ib = torch.where(ib == ia, (ib + 1) % ns, ib)
        ca = torch.gather(order, 1, ia.T)                     # [R, C]
        cb = torch.gather(order, 1, ib.T)
        dab = u_all[rr[:, None], ca] - u_all[rr[:, None], cb]  # [R, C, D]
        if wrap is not None:
            # minimal image of the survivor difference on periodic dims
            dab = torch.where(wrap, dab - torch.round(dab), dab)
        dirv = dab.transpose(0, 1) * act                      # [C, R, D]
        nvec = _whiten(chol, dirv)
        nrm = torch.clamp(torch.linalg.vector_norm(nvec, dim=-1,
                                                   keepdim=True), min=1e-30)
        return nvec / nrm, dirv / nrm

    ncall = torch.zeros((R,), dtype=torch.int32, device=x.device)
    moved = torch.zeros((C, R), dtype=torch.bool, device=x.device)
    for j in range(n_rep):
        use_d = mode == "diff" or (mode == "mix" and j % 2 == 0)
        nvec, dirv = diff_dir() if use_d else gauss_dir()
        t_lo, t_hi = _line_bracket(x, dirv, z, nvec, rmax[None, :],
                                   wrap=wrap)
        xn, lnln, t_acc, acc, nc = _shrink_slice(
            loglike2, data, shift, gen, x, lnl_x, dirv, t_lo, t_hi,
            thr_b, dead_b, cfg, wrap=wrap,
        )
        upd = (~dead_b) & acc
        x = torch.where(upd[..., None], xn, x)
        z = z + torch.where(upd, t_acc, 0.0)[..., None] * nvec
        lnl_x = torch.where(upd, lnln, lnl_x)
        ncall = ncall + torch.sum(nc, dim=0, dtype=torch.int32)
        moved = moved | upd
    return x, lnl_x, ncall, moved


#: constant tensors built from host values, per device and dtype: an
#: iteration copies nothing from the host
_CONSTS = {}


def _act_arrays(cfg: NSConfig, ndim: int, like):
    """Active-dimension mask: likelihood-flat dims are excluded from the
    bounding geometry and sampled uniformly."""
    act_np = np.ones(ndim, dtype=np.float64)
    for fd in cfg.flat_dims:
        if 0 <= int(fd) < ndim:
            act_np[int(fd)] = 0.0
    key = ("act", act_np.tobytes(), like.dtype, like.device)
    if key not in _CONSTS:
        _CONSTS[key] = torch.as_tensor(act_np, dtype=like.dtype,
                                       device=like.device)
    return _CONSTS[key], act_np


def _efr_mult(cfg: NSConfig, d_act: float) -> float:
    """MultiNest's efr as a radius multiplier: ellipsoid volumes grow by
    1/efr; clamped at 1, so efr > 1 is a no-op (see the JAX package)."""
    if cfg.efr > 0:
        return max(1.0, (1.0 / cfg.efr) ** (1.0 / max(d_act, 1.0)))
    return 1.0


def _shrunk_cov(u, mean, live_w, n_live, act, act_np, cfg):
    """Survivor covariance shrunk toward the isotropic target (see the
    JAX package); flat dims get a unit diagonal."""
    D = u.shape[-1]
    du = (u - mean[:, None, :]) * live_w[..., None] * act
    cov = torch.einsum("rld,rle->rde", du, du) / n_live[:, None, None]
    d_act = max(float(act_np.sum()), 1.0)
    lam = torch.clamp(D / n_live, 0.0, 0.3)[:, None, None]
    mean_eig = (torch.sum(torch.diagonal(cov, dim1=-2, dim2=-1) * act,
                          dim=-1) / d_act)[:, None, None]
    cov = (1.0 - lam) * cov + lam * mean_eig * torch.diag(act)
    return cov + torch.diag(torch.where(act > 0, cfg.cov_reg, 1.0))


def _live_moments(u, zombie):
    live_w = (~zombie).to(u.dtype)
    n_live = torch.clamp(torch.sum(live_w, dim=1), min=1.0)
    mean = torch.einsum("rl,rld->rd", live_w, u) / n_live[:, None]
    return live_w, n_live, mean


def _radius(chol, mean, u, act, act_np, cfg):
    """Bounding radius covering every slot (zombie shell included)."""
    du_all = (u - mean[:, None, :]) * act
    dz = _tri_solve(chol, du_all.transpose(1, 2))          # [R, D, L]
    rmax = torch.sqrt(torch.amax(torch.sum(dz**2, dim=1), dim=1))
    return torch.clamp(rmax, min=0.1) * (
        cfg.ell_fudge * _efr_mult(cfg, float(act_np.sum())))


def _slim_bounds(u, zombie, act, act_np, cfg: NSConfig):
    """Global whitening + bounding radius only: ``(chol, mean, rmax)``."""
    live_w, n_live, mean = _live_moments(u, zombie)
    chol = _chol(_shrunk_cov(u, mean, live_w, n_live, act, act_np, cfg))
    return chol, mean, _radius(chol, mean, u, act, act_np, cfg)


def _compute_bounds(u, zombie, act, act_np, cfg: NSConfig):
    """Bounding geometry of the surviving live set: the 7-tuple
    ``(mu_all, chol_all, rmax_all, lnvol_all, act_ell, use_cube,
    inv_chol)`` over the ellipsoid set (index 0 = global, 1.. = k-means
    clusters refined by Mahalanobis reassignment), or the slim 3-tuple
    for ``method == "slice"`` (see the JAX package)."""
    R, L, D = u.shape
    dtype, dev = u.dtype, u.device
    if cfg.method == "slice":
        return _slim_bounds(u, zombie, act, act_np, cfg)
    live_w, n_live, mean = _live_moments(u, zombie)
    cov = _shrunk_cov(u, mean, live_w, n_live, act, act_np, cfg)
    chol = _chol(cov)

    KC = max(1, cfg.n_clusters)
    km_iters = max(1, cfg.km_iters)
    kk = torch.arange(KC, device=dev)
    zorder = torch.argsort((~zombie).to(torch.uint8), dim=1, stable=True)
    # k-means over the survivors in whitened coordinates, seeded from
    # evenly spaced survivors (zorder lists zombies first)
    du0 = (u - mean[:, None, :]) * act
    zpts = _tri_solve(chol, du0.transpose(1, 2)).transpose(1, 2)  # [R, L, D]
    seed_frac = torch.linspace(0.0, 1.0, KC, device=dev, dtype=dtype)[None, :]
    seed_pos = L - 1 - seed_frac * (n_live[:, None] - 1.0)
    seed_pos = torch.clamp(seed_pos.to(torch.int64), 0, L - 1)
    seed_ix = torch.gather(zorder, 1, seed_pos)
    centers = torch.gather(zpts, 1, seed_ix[..., None].expand(-1, -1, D))
    big = 1e10
    for _ in range(km_iters):
        d2 = torch.sum((zpts[:, :, None, :] - centers[:, None, :, :]) ** 2,
                       dim=-1)                               # [R, L, KC]
        assign = torch.argmin(d2, dim=-1)
        wk = ((assign[..., None] == kk) & (~zombie)[..., None]).to(dtype)
        cnt = torch.sum(wk, dim=1)                           # [R, KC]
        new_c = torch.einsum("rlk,rld->rkd", wk, zpts) \
            / torch.clamp(cnt, min=1.0)[..., None]
        centers = torch.where((cnt > 0)[..., None], new_c, centers)

    act_outer = act[:, None] * act[None, :]
    flat_diag = torch.diag(torch.where(act > 0, cfg.cov_reg, 1.0))

    def cluster_geom(assign):
        """Per-cluster ellipsoids from an assignment (cube-space moments
        of the surviving members, shrunk toward the global covariance
        for small clusters; radius over every assigned slot) and the
        squared Mahalanobis distance of every point to every cluster."""
        onehot = assign[..., None] == kk
        wk = (onehot & (~zombie)[..., None]).to(dtype)      # [R, L, KC]
        cnt = torch.sum(wk, dim=1)
        mu_k = torch.einsum("rlk,rld->rkd", wk, u) \
            / torch.clamp(cnt, min=1.0)[..., None]
        mu_k = torch.where((cnt > 0)[..., None], mu_k, mean[:, None])
        du_k = (u[:, :, None, :] - mu_k[:, None]) * wk[..., None] * act
        cov_k = torch.einsum("rlkd,rlke->rkde", du_k, du_k) \
            / torch.clamp(cnt, min=1.0)[..., None, None]
        lam = torch.clamp((D + 1.0 - cnt) / (D + 1.0), 0.0, 1.0)
        cov_k = (1.0 - lam)[..., None, None] * cov_k \
            + lam[..., None, None] * cov[:, None]
        cov_k = cov_k * act_outer + flat_diag
        chol_k = _chol(cov_k)                               # [R, KC, D, D]
        du_all = (u[:, :, None, :] - mu_k[:, None]) * act   # [R, L, KC, D]
        dz_k = _tri_solve(chol_k, du_all.permute(0, 2, 3, 1))  # [R,KC,D,L]
        d2 = torch.sum(dz_k**2, dim=2).transpose(1, 2)      # [R, L, KC]
        rmax2 = torch.amax(d2 * onehot.to(dtype), dim=1)    # [R, KC]
        return cnt, mu_k, chol_k, d2, rmax2

    cnt, mu_k, chol_k, d2, rmax2 = cluster_geom(assign)
    for _ in range(max(0, cfg.km_refine)):
        score = d2 / torch.clamp(rmax2, min=0.01)[:, None, :]
        score = torch.where((cnt > 0)[:, None, :], score, big)
        assign = torch.argmin(score, dim=-1)
        cnt, mu_k, chol_k, d2, rmax2 = cluster_geom(assign)
    d_act = float(act_np.sum())
    rmax_k = torch.clamp(torch.sqrt(rmax2), min=0.1) * (
        cfg.ell_fudge * _efr_mult(cfg, d_act))
    rmax_g = _radius(chol, mean, u, act, act_np, cfg)

    def ell_lnvol(rmax, chol_m):
        return d_act * torch.log(rmax) + torch.sum(
            torch.log(torch.diagonal(chol_m, dim1=-2, dim2=-1)) * act, dim=-1)

    lnvol_k = torch.where(cnt > 0, ell_lnvol(rmax_k, chol_k), -big)
    lnvol_g = ell_lnvol(rmax_g, chol)
    use_multi = torch.logsumexp(lnvol_k, dim=-1) \
        < lnvol_g + float(np.log(cfg.cluster_vol_frac))
    mu_all = torch.cat([mean[:, None], mu_k], dim=1)
    chol_all = torch.cat([chol[:, None], chol_k], dim=1)
    rmax_all = torch.cat([rmax_g[:, None], rmax_k], dim=1)
    act_ell = torch.cat([(~use_multi)[:, None],
                         use_multi[:, None] & (cnt > 0)], dim=1)
    lnvol_all = torch.where(
        act_ell, torch.cat([lnvol_g[:, None], lnvol_k], dim=1), -big)
    # start-up phase: sample the prior cube while the bound is larger
    use_cube = lnvol_g >= 0.0
    eye = torch.eye(D, dtype=dtype, device=dev).expand(R, KC + 1, D, D)
    inv_chol = _tri_solve(chol_all, eye)
    return (mu_all, chol_all, rmax_all, lnvol_all, act_ell, use_cube,
            inv_chol)


def _global_ell(bounds):
    """Global ``(chol, mean, rmax)`` from either bounds tuple."""
    if len(bounds) == 7:
        mu_all, chol_all, rmax_all = bounds[0], bounds[1], bounds[2]
        return chol_all[:, 0], mu_all[:, 0], rmax_all[:, 0]
    return bounds


def ns_init(gen, loglike2, data, ndim: int, n_runs: int, cfg: NSConfig,
            dtype=torch.float32) -> _State:
    """Draw and evaluate the initial live-point set (stratified, with
    the oversampled-init kill-down when ``init_factor > 1``)."""
    cfg = cfg.resolved(ndim)
    R, L, D = n_runs, cfg.nlive, ndim
    dev = gen.device
    like = torch.empty((), dtype=dtype, device=dev)
    n_id = min(cfg.n_init_dead(), cfg.max_iter)
    L0 = L + n_id
    u0 = _rand(gen, (L0, R, D), like)
    if cfg.init_stratified and L0 > 1:
        scores = _rand(gen, (L0, R, D), like)
        ranks = torch.argsort(torch.argsort(scores, dim=0), dim=0)
        u0 = (ranks.to(dtype) + u0) / L0
    c = max(1, min(cfg.init_chunk, L0))
    lnl0 = torch.cat([loglike2(u0[k:k + c], data)
                      for k in range(0, L0, c)], dim=0)       # [L0, R]
    u0 = u0.permute(1, 0, 2).contiguous()                    # [R, L0, D]
    lnl0 = lnl0.T.contiguous()
    shift = torch.amax(lnl0, dim=1)
    lnl0 = lnl0 - shift[:, None]
    dead_u = torch.zeros((R, cfg.max_iter, D), dtype=dtype, device=dev)
    dead_lnl = torch.full((R, cfg.max_iter), _NEG, dtype=dtype, device=dev)
    lnz0 = torch.full((R,), _NEG, dtype=dtype, device=dev)
    if n_id > 0:
        # kill-down: the worst n_id die in ascending order, the best L live
        worst_lnl, worst_ix = torch.topk(lnl0, n_id, dim=1, largest=False)
        dead_u[:, :n_id] = torch.gather(
            u0, 1, worst_ix[..., None].expand(-1, -1, D))
        dead_lnl[:, :n_id] = worst_lnl
        _, lnw_np = _weight_tables(L, cfg.kill_k, cfg.max_iter, n_id)
        lnw_init = torch.as_tensor(lnw_np[:n_id], dtype=dtype, device=dev)
        lnz0 = torch.logsumexp(lnw_init[None, :] + worst_lnl, dim=1)
        lnl0, live_ix = torch.topk(lnl0, L, dim=1)
        u0 = torch.gather(u0, 1, live_ix[..., None].expand(-1, -1, D))
    act, act_np = _act_arrays(cfg, D, like)
    zombie0 = torch.zeros((R, L), dtype=torch.bool, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return _State(
        gen=gen, u=u0, lnl=lnl0, lnl_shift=shift, lnz=lnz0,
        done=torch.zeros((R,), dtype=torch.bool, device=dev),
        converged=torch.zeros((R,), dtype=torch.bool, device=dev),
        n_deaths=torch.full((R,), n_id, **i32),
        pending=torch.zeros((R,), **i32),
        thresh=torch.full((R,), _NEG, dtype=dtype, device=dev),
        zombie=zombie0,
        stall=torch.zeros((R,), **i32),
        ncall=torch.full((R,), L0, **i32),
        dead_u=dead_u, dead_lnl=dead_lnl, i=0,
        bounds=_compute_bounds(u0, zombie0, act, act_np, cfg),
        acc_ema=torch.ones((), dtype=dtype, device=dev),
        ceff_mult=torch.ones((R,), dtype=dtype, device=dev),
    )


def _kill_select(s: _State, cfg: NSConfig, lnw_tab, rr):
    """One batched-deletion step: the kill_k worst live points of every
    run whose previous fill-cycle completed.  Writes nothing; returns
    ``(kills, lnz, n_deaths, pending, zombie, thresh)``, ``kills`` the
    step's dead records ``(rows, cols, u, lnl, ok)`` for
    :func:`_record_kills`."""
    R, L, D = s.u.shape
    K = cfg.kill_k
    max_iter = cfg.max_iter
    need_kill = (~s.done) & (s.pending == 0)
    kill_lnl, worst_idx = torch.topk(s.lnl, K, dim=1, largest=False)
    thresh_new = kill_lnl[:, -1]
    kill_u = torch.gather(s.u, 1, worst_idx[..., None].expand(-1, -1, D))
    pos = s.n_deaths[:, None].long() + torch.arange(K, device=rr.device)
    ok_w = need_kill[:, None] & (pos < max_iter)
    rrk = rr[:, None].expand(R, K)
    # slots past the budget (n_deaths <= max_iter) write back K columns
    # lower, where no slot of the row writes: every pair stays distinct
    pos_w = torch.where(pos < max_iter, pos, pos - K)
    lnw_k = lnw_tab[torch.clamp(pos, 0, max_iter - 1)]
    contrib = torch.logsumexp(
        torch.where(ok_w, lnw_k + kill_lnl, _NEG), dim=1)
    lnz = torch.where(need_kill, torch.logaddexp(s.lnz, contrib), s.lnz)
    n_deaths = torch.where(
        need_kill, torch.clamp(s.n_deaths + K, max=max_iter), s.n_deaths)
    pending = torch.where(need_kill, K, s.pending).to(torch.int32)
    zombie = _put(s.zombie, rrk, worst_idx, torch.ones_like(ok_w),
                  need_kill[:, None].expand(R, K))
    thresh = torch.where(need_kill, thresh_new, s.thresh)
    return (rrk, pos_w, kill_u, kill_lnl, ok_w), lnz, n_deaths, pending, \
        zombie, thresh


def _record_kills(dead_u, dead_lnl, kills):
    """Write a step's dead records (:func:`_kill_select`) into the dead
    buffers, in place."""
    rows, cols, kill_u, kill_lnl, ok = kills
    _put_inplace(dead_u, rows, cols, kill_u, ok)
    _put_inplace(dead_lnl, rows, cols, kill_lnl, ok)


def _kill_record(s: _State, cfg: NSConfig, lnw_tab, rr):
    """:func:`_kill_select`, its records written into the dead buffers
    of ``s`` in place; returns ``(lnz, n_deaths, pending, zombie,
    thresh)`` (``zombie`` a new tensor)."""
    kills, *rest = _kill_select(s, cfg, lnw_tab, rr)
    _record_kills(s.dead_u, s.dead_lnl, kills)
    return tuple(rest)


def _check_termination(cfg: NSConfig, lnx_tab, done, zombie, lnl, lnz,
                       n_deaths, stall=None):
    """Remaining-evidence + float-plateau + stuck-run termination."""
    lnx = lnx_tab[n_deaths.long()]
    lnl_live_max = torch.amax(torch.where(zombie, _NEG, lnl), dim=1)
    dlogz = torch.logaddexp(lnz, lnx + lnl_live_max) - lnz
    lnl_live_min = torch.amin(torch.where(zombie, -_NEG, lnl), dim=1)
    eps_plat = 16.0 * torch.finfo(lnl.dtype).eps * torch.clamp(
        torch.abs(lnl_live_max), min=1.0)
    plateau = (lnl_live_max - lnl_live_min) <= eps_plat
    newly_conv = (~done) & ((dlogz < cfg.tol) | plateau)
    newly_done = newly_conv | ((~done) & (n_deaths >= cfg.max_iter))
    if stall is not None and cfg.stall_limit > 0:
        newly_done = newly_done | ((~done) & (stall >= cfg.stall_limit))
    return newly_done, newly_conv


def _tables(cfg: NSConfig, L: int, like):
    """``(lnx_tab, lnw_tab)`` of :func:`_weight_tables` on ``like``'s
    device and dtype (built once)."""
    key = ("tables", L, cfg.kill_k, cfg.max_iter, cfg.n_init_dead(),
           like.dtype, like.device)
    if key not in _CONSTS:
        lnx_np, lnw_np = _weight_tables(L, cfg.kill_k, cfg.max_iter,
                                        cfg.n_init_dead())
        _CONSTS[key] = tuple(
            torch.as_tensor(t, dtype=like.dtype, device=like.device)
            for t in (lnx_np, lnw_np))
    return _CONSTS[key]


def _running(s: _State, seg_end: int) -> bool:
    """Loop condition of every segment: not all done, i < seg_end (the
    done mask is read on the host)."""
    return s.i < seg_end and not bool(to_host(s.done.all(), "ns.running"))


def _fill(s, rows, slots, cand, cand_lnl, use, zombie):
    """Insert accepted points into their slots: new ``(u, lnl, zombie)``
    (a slot repeats only where ``use`` is False)."""
    return (_put(s.u, rows, slots, cand, use),
            _put(s.lnl, rows, slots, cand_lnl, use),
            _put(zombie, rows, slots, torch.zeros_like(use), use))


def _core_step(s: _State, loglike2, data, cfg: NSConfig,
               refresh: bool) -> _State:
    """One candidate iteration (the loop body of the JAX package's
    ``_segment_core``): kill/record, the bounding geometry (rebuilt when
    ``refresh``), one batched proposal launch (ellipsoid candidates, or
    one slice chain per run for ``method="slice"``), fills, termination.
    Every row that is done stays as it is.  ``cfg`` is resolved."""
    out, kills = _cand_iter(s, loglike2, data, cfg, refresh)
    _record_kills(s.dead_u, s.dead_lnl, kills)
    return out


def _cand_iter(s: _State, loglike2, data, cfg: NSConfig, refresh: bool):
    """:func:`_core_step` without the write into the dead buffers, which
    it does not read: returns ``(state, kills)``."""
    R, L, D = s.u.shape
    like = s.u
    dtype = like.dtype
    T = cfg.n_cand()
    lnx_tab, lnw_tab = _tables(cfg, L, like)
    rr = torch.arange(R, device=like.device)
    act, act_np = _act_arrays(cfg, D, like)
    any_flat = bool((act_np == 0.0).any())
    d_act = float(act_np.sum())
    d_exp = 1.0 / max(d_act, 1.0)
    wrap = _wrap_vec(cfg, D, like)
    gen = s.gen
    shift = s.lnl_shift
    kills, lnz, n_deaths, pending, zombie, thresh = _kill_select(
        s, cfg, lnw_tab, rr)
    active = (~s.done) & (pending > 0)
    # periodic dims: the geometry sees minimal-image coordinates
    u_geo = _recenter(s.u, wrap)
    bounds = _compute_bounds(u_geo, zombie, act, act_np, cfg) if refresh \
        else s.bounds
    # zombie slots first (stable sort on ~zombie: False < True)
    zorder = torch.argsort((~zombie).to(torch.uint8), dim=1, stable=True)
    acc_ema, ceff_mult = s.acc_ema, s.ceff_mult
    if cfg.method != "slice":
        (mu_all, chol_all, rmax_all, lnvol_all, act_ell, use_cube,
         inv_chol) = bounds
        KC = mu_all.shape[1] - 1
        # constant-efficiency mode: per-run radius scale (<= 1)
        s_ceff = s.ceff_mult ** (1.0 / max(d_act, 1.0)) if cfg.ceff \
            else None

        def draw_round():
            # volume-proportional ellipsoid choice (Gumbel-max), then a
            # uniform point in the chosen ellipsoid
            gmb = -torch.log(-torch.log(
                _rand(gen, (T, R, KC + 1), like).clamp(min=1e-30)))
            kc = torch.argmax(gmb + lnvol_all[None], dim=-1).T   # [R, T]
            chol_sel = torch.gather(
                chol_all, 1, kc[..., None, None].expand(R, T, D, D))
            mu_sel = torch.gather(mu_all, 1, kc[..., None].expand(R, T, D))
            r_sel = torch.gather(rmax_all, 1, kc)                # [R, T]
            if s_ceff is not None:
                r_sel = r_sel * s_ceff[:, None]
            y = _randn(gen, (T, R, D), like) * act
            y = y / torch.clamp(torch.linalg.vector_norm(
                y, dim=-1, keepdim=True), min=1e-30)
            rad = _rand(gen, (T, R), like) ** d_exp
            z = (r_sel.T * rad)[..., None] * y
            xj = mu_sel.transpose(0, 1) + torch.einsum(
                "rtde,tre->trd", chol_sel, z)                   # [T, R, D]
            in_ok = ((xj >= 0.0) & (xj <= 1.0)) | (act <= 0.0)
            if wrap is not None:
                in_ok = in_ok | wrap     # periodic dims wrap instead
            return xj, torch.all(in_ok, dim=-1)

        cand, got = draw_round()
        for _ in range(max(1, cfg.cube_redraws) - 1):
            xj, in_j = draw_round()
            cand = torch.where(((~got) & in_j)[..., None], xj, cand)
            got = got | in_j
        ucube = _rand(gen, (T, R, D), like)
        cand = torch.where(use_cube[None, :, None], ucube, cand)
        if any_flat:
            cand = torch.where(act > 0, cand, ucube)
        cand = _wrap_pts(cand, wrap)
        # overlap thinning: keep with probability 1/#ellipsoids holding it
        # (minimal-image offsets on periodic dims)
        xc = cand[:, :, None, :] - mu_all[None]                 # [T,R,K+1,D]
        if wrap is not None:
            xc = torch.where(wrap, xc - torch.round(xc), xc)
        xc = xc * act
        m2 = torch.sum(torch.einsum("rkde,trke->trkd", inv_chol, xc) ** 2,
                       dim=-1)
        r_thin = rmax_all if s_ceff is None else rmax_all * s_ceff[:, None]
        inside = (m2 <= r_thin[None] ** 2) & act_ell[None]
        n_e = torch.clamp(torch.sum(inside, dim=-1), min=1)
        thin = (_rand(gen, (T, R), like) * n_e < 1.0) | use_cube[None, :]
        inb = torch.all((cand >= 0.0) & (cand <= 1.0), dim=-1)
        cand_lnl = torch.where(
            inb, loglike2(torch.clamp(cand, 0.0, 1.0), data) - shift, _NEG)
        okc = (cand_lnl > thresh) & active[None, :] & thin
        ncall = s.ncall + active.to(torch.int32) * T
        # acceptance EMA over union-proposal runs only (cube start-up
        # runs carry no signal about the union's fit)
        sig = active & ~use_cube
        n_sig = torch.sum(sig.to(dtype))
        acc = torch.sum((okc & sig[None, :]).to(dtype)) \
            / torch.clamp(n_sig * T, min=1.0)
        acc_ema = torch.where(n_sig > 0, 0.8 * s.acc_ema + 0.2 * acc,
                              s.acc_ema)
        if cfg.ceff:
            # constant-efficiency controller: multiplicative volume
            # update toward the target acceptance, per run
            target = cfg.efr if cfg.efr > 0 else 0.3
            acc_r = torch.sum(okc.to(dtype), dim=0) / float(T)
            ceff_mult = torch.where(
                active & ~use_cube,
                torch.clamp(s.ceff_mult * torch.exp(0.5 * (acc_r - target)),
                            float(np.exp(-6.0)), 1.0),
                s.ceff_mult)
    else:
        # slice method: one slice chain per run from a random survivor
        # yields one candidate (kill_k == 1)
        nz_cnt = torch.clamp(L - pending, min=1)
        jsel = torch.randint(0, 1 << 30, (R,), generator=gen,
                             device=like.device)
        sel = torch.gather(zorder, 1,
                           (L - 1 - (jsel % nz_cnt))[:, None].long())[:, 0]
        x0 = u_geo[rr, sel][None]                               # [1, R, D]
        lnl0 = torch.gather(s.lnl, 1, sel[:, None])[:, 0][None]
        chol_g, mu_g, rmax_g = _global_ell(bounds)
        z0 = _whiten(chol_g, (x0 - mu_g[None]) * act)
        x, cand_lnl, nc, moved = _slice_chains(
            gen, loglike2, data, shift, x0, z0, lnl0, thresh[None, :],
            (~active)[None, :], chol_g, rmax_g, act, cfg.n_repeats, cfg,
            u_all=s.u, order=torch.flip(zorder, dims=(1,)), n_surv=nz_cnt,
            wrap=wrap)
        cand = _wrap_pts(x, wrap)
        okc = moved & (cand_lnl > thresh) & active[None, :]
        ncall = s.ncall + nc

    # fill zombie slots with accepted candidates
    Tc = cand.shape[0]
    rank = torch.cumsum(okc.to(torch.int32), dim=0)             # [T, R]
    use = okc & (rank <= pending[None, :])
    slot = torch.gather(
        zorder, 1, torch.clamp(rank - 1, 0, L - 1).T.long()).T  # [T, R]
    rows = rr[None, :].expand(Tc, R)
    u_new, lnl_new, zombie = _fill(s, rows, slot, cand, cand_lnl, use,
                                   zombie)
    n_take = torch.sum(use, dim=0, dtype=torch.int32)
    pending = pending - n_take
    stall = torch.where(active & (n_take == 0) & (pending > 0),
                        s.stall + 1, 0).to(torch.int32)
    newly_done, newly_conv = _check_termination(
        cfg, lnx_tab, s.done, zombie, lnl_new, lnz, n_deaths, stall)
    return dataclasses.replace(
        s, u=u_new, lnl=lnl_new, lnz=lnz, done=s.done | newly_done,
        converged=s.converged | newly_conv, n_deaths=n_deaths,
        pending=pending, thresh=thresh, zombie=zombie, stall=stall,
        ncall=ncall, i=s.i + 1, bounds=bounds, acc_ema=acc_ema,
        ceff_mult=ceff_mult), kills


class _Units:
    """The segmented loop's units of work, run eagerly on the run's own
    tensors: a candidate iteration, the slice fill after a candidate
    block, a kill+slice iteration.  ``graphs.SegmentedRun`` runs the same
    units on kept static states, as CUDA graph replays on the card.
    ``cfg`` is resolved."""

    def __init__(self, loglike2, cfg: NSConfig, data=None):
        self.loglike2, self.cfg, self.data = loglike2, cfg, data

    def enter(self, state: _State, data) -> _State:
        """Start a segment of ``state`` on ``data``."""
        self.data = data
        return state

    def own(self, state: _State) -> _State:
        """``state`` with no tensor that a later segment overwrites."""
        return state

    def close(self, state: _State) -> _State:
        """The run's final state, owned by the caller."""
        return state

    def _count(self, s: _State):
        if s.u.is_cuda:
            count("ns.eager_steps")

    def cand(self, s: _State, refresh: bool) -> _State:
        self._count(s)
        return _core_step(s, self.loglike2, self.data, self.cfg, refresh)

    def fill(self, s: _State) -> _State:
        self._count(s)
        return _slice_fill_pass(s, self.loglike2, self.data, self.cfg)

    def slice(self, s: _State, slim: bool) -> _State:
        self._count(s)
        out, kills = _slice_iter(s, self.loglike2, self.data, self.cfg, slim)
        _record_kills(s.dead_u, s.dead_lnl, kills)
        return out


def _segment_core(state: _State, loglike2, data, cfg: NSConfig,
                  seg_end: int, units: _Units = None) -> _State:
    """Advance all runs until ``i >= seg_end`` or every run is done with
    kill/record + candidate proposals only (``units``: a segment already
    entered)."""
    cfg = cfg.resolved(state.u.shape[-1])
    units = units or _Units(loglike2, cfg, data)
    be = max(1, cfg.bound_every)
    s = state
    while _running(s, seg_end):
        s = units.cand(s, s.i % be == 0)
    return s


def _slice_pass(s: _State, u_geo, loglike2, data, cfg, chol, mu, rmax, act,
                pending, zombie, thresh, need, n_rep, wrap):
    """Advance ``kill_k`` slice chains per run from DISTINCT random
    survivors (read from ``u_geo``, the minimal-image live points) and
    insert the moved endpoints into the pending zombie slots.  Returns
    ``(u, lnl, zombie, pending, n_ins, nc)``."""
    R, L, D = s.u.shape
    C = cfg.kill_k
    rr = torch.arange(R, device=s.u.device)
    rrc = rr[None, :].expand(C, R)
    # one randomized sort: survivors in random order first, zombies last
    rscore = _rand(s.gen, (R, L), s.u) + zombie.to(s.u.dtype) * 2.0
    order = torch.argsort(rscore, dim=1)                     # [R, L]
    sel = order[:, :C].T                                     # [C, R]
    x = u_geo[rrc, sel]
    lnl_x = s.lnl[rrc, sel]
    z = _whiten(chol, (x - mu[None]) * act)
    x, lnl_x, nc, moved = _slice_chains(
        s.gen, loglike2, data, s.lnl_shift, x, z, lnl_x,
        thresh[None, :].expand(C, R), (~need)[None, :].expand(C, R),
        chol, rmax, act, n_rep, cfg,
        u_all=s.u, order=order, n_surv=L - pending, wrap=wrap,
    )
    x = _wrap_pts(x, wrap)
    okf = moved & need[None, :]
    rankf = torch.cumsum(okf.to(torch.int32), dim=0)         # [C, R]
    usef = okf & (rankf <= pending[None, :])
    pos = torch.clamp(L - rankf, 0, L - 1).long()
    slotf = torch.gather(order, 1, pos.T).T                  # [C, R]
    u_new, lnl_new, zombie = _fill(s, rrc, slotf, x, lnl_x, usef, zombie)
    n_ins = torch.sum(usef, dim=0, dtype=torch.int32)
    return u_new, lnl_new, zombie, pending - n_ins, n_ins, nc


def _slice_iter(s: _State, loglike2, data, cfg: NSConfig, slim: bool):
    """One kill+slice iteration, the whitening rebuilt when ``slim``;
    writes nothing into the dead buffers: returns ``(state, kills)``.
    ``cfg`` is resolved."""
    R, L, D = s.u.shape
    like = s.u
    lnx_tab, lnw_tab = _tables(cfg, L, like)
    rr = torch.arange(R, device=like.device)
    act, act_np = _act_arrays(cfg, D, like)
    wrap = _wrap_vec(cfg, D, like)
    n_rep = (cfg.n_repeats if cfg.method == "slice"
             else cfg.fallback_repeats)
    kills, lnz, n_deaths, pending, zombie, thresh = _kill_select(
        s, cfg, lnw_tab, rr)
    u_geo = _recenter(s.u, wrap)
    if slim:
        chol, mu, rmax = _slim_bounds(u_geo, zombie, act, act_np, cfg)
    else:
        chol, mu, rmax = s.bounds
    need = (~s.done) & (pending > 0)
    u_new, lnl_new, zombie, pending, n_ins, nc = _slice_pass(
        s, u_geo, loglike2, data, cfg, chol, mu, rmax, act, pending,
        zombie, thresh, need, n_rep, wrap)
    stall = torch.where(
        need & (n_ins == 0) & (pending > 0), s.stall + 1,
        torch.where(n_ins > 0, 0, s.stall)).to(torch.int32)
    newly_done, newly_conv = _check_termination(
        cfg, lnx_tab, s.done, zombie, lnl_new, lnz, n_deaths, stall)
    return dataclasses.replace(
        s, u=u_new, lnl=lnl_new, lnz=lnz, done=s.done | newly_done,
        converged=s.converged | newly_conv, n_deaths=n_deaths,
        pending=pending, thresh=thresh, zombie=zombie, stall=stall,
        ncall=s.ncall + nc, i=s.i + 1, bounds=(chol, mu, rmax)), kills


def ns_segment_slice(state: _State, loglike2, data, cfg: NSConfig,
                     seg_end: int, units: _Units = None) -> _State:
    """Advance runs with kill + multi-chain slice iterations until
    ``i >= seg_end`` or every run is done (the kill+slice regime;
    ``units`` runs the iterations, eagerly by default)."""
    cfg = cfg.resolved(state.u.shape[-1])
    units = units or _Units(loglike2, cfg)
    sbe = max(1, cfg.slice_bound_every)
    s = units.enter(state, data)
    while _running(s, seg_end):
        s = units.slice(s, sbe == 1 or s.i % sbe == 0)
    return s


def ns_rebuild_bounds(state: _State, cfg: NSConfig):
    """Rebuild the full candidate geometry and ESTIMATE the would-be
    candidate acceptance ``X / V_union`` with zero likelihood
    evaluations; returns ``(state, est_mean)`` (see the JAX package)."""
    R, L, D = state.u.shape
    cfg = cfg.resolved(D)
    like = state.u
    act, act_np = _act_arrays(cfg, D, like)
    u_geo = _recenter(state.u, _wrap_vec(cfg, D, like))
    bounds = _compute_bounds(u_geo, state.zombie, act, act_np, cfg)
    lnvol_sum = torch.logsumexp(bounds[3], dim=-1)
    d_act = float(act_np.sum())
    lnball = float(0.5 * d_act * np.log(np.pi)
                   - math.lgamma(0.5 * d_act + 1.0))
    lnx_tab, _ = _tables(cfg, L, like)
    lnx = lnx_tab[torch.clamp(state.n_deaths, 0, cfg.max_iter).long()]
    est = torch.exp(torch.clamp(lnx - (lnvol_sum + lnball), -60.0, 0.0))
    active = ~state.done
    n_act = torch.clamp(torch.sum(active.to(like.dtype)), min=1.0)
    est_mean = torch.sum(torch.where(active, est, 0.0)) / n_act
    return dataclasses.replace(state, bounds=bounds), est_mean


def ns_slice_fill(state: _State, loglike2, data, cfg: NSConfig,
                  units: _Units = None) -> _State:
    """Fill pending kill slots with one batched multi-chain slice pass
    from the cached global geometry.  Nothing pending leaves the state
    unchanged (the JAX package's masked pass evaluates nothing then), so
    that case is decided on the host and skipped (``units``: a segment
    already entered)."""
    need = (~state.done) & (state.pending > 0)
    if not bool(to_host(need.any(), "ns.fill_need")):
        return state
    units = units or _Units(loglike2, cfg.resolved(state.u.shape[-1]), data)
    return units.fill(state)


def _slice_fill_pass(s: _State, loglike2, data, cfg: NSConfig) -> _State:
    """:func:`ns_slice_fill` without the host's check: masked, it leaves
    every field but the generator as it is when nothing is pending.
    ``cfg`` is resolved."""
    R, L, D = s.u.shape
    need = (~s.done) & (s.pending > 0)
    act, _ = _act_arrays(cfg, D, s.u)
    wrap = _wrap_vec(cfg, D, s.u)
    chol, mu, rmax = _global_ell(s.bounds)
    u_new, lnl_new, zombie, pending, n_ins, nc = _slice_pass(
        s, _recenter(s.u, wrap), loglike2, data, cfg, chol, mu, rmax, act,
        s.pending, s.zombie, s.thresh, need, cfg.fallback_repeats, wrap)
    return dataclasses.replace(
        s, u=u_new, lnl=lnl_new, zombie=zombie, pending=pending,
        ncall=s.ncall + nc,
        stall=torch.where(n_ins > 0, 0, s.stall).to(torch.int32))


def ns_segment(state: _State, loglike2, data, cfg: NSConfig,
               seg_end: int, units: _Units = None) -> _State:
    """The candidate program: blocks of ``block_iters`` candidate
    iterations, each followed by a slice-fill rescue pass, until
    ``i >= seg_end`` or every run is done (``units`` runs the iterations
    and fills, eagerly by default)."""
    cfg = cfg.resolved(state.u.shape[-1])
    units = units or _Units(loglike2, cfg)
    block = max(1, cfg.block_iters)
    s = units.enter(state, data)
    while _running(s, seg_end):
        s = _segment_core(s, loglike2, data, cfg, min(s.i + block, seg_end),
                          units)
        s = ns_slice_fill(s, loglike2, data, cfg, units)
        count("ns.blocks")
    return s


def _traced_block(s: _State, loglike2, data, cfg: NSConfig,
                  n_iters: int) -> _State:
    """One pass of the traced mode's loop (the body of the JAX package's
    ``ns_segment``): ``n_iters`` masked candidate iterations, then one
    unconditional masked slice fill.  The host counter ``i`` decides the
    bound refreshes and nothing else.  ``cfg`` is resolved."""
    be = max(1, cfg.bound_every)
    for _ in range(n_iters):
        s = _core_step(s, loglike2, data, cfg, s.i % be == 0)
    return _slice_fill_pass(s, loglike2, data, cfg)


def ns_traced(state: _State, loglike2, data, cfg: NSConfig) -> _State:
    """The traced mode's plain block loop: blocks of ``block_iters``
    (:func:`_traced_block`) until every run is done or ``i`` reaches
    ``max_iter``, the JAX package's ``ns_segment(state, ..., max_iter)``.
    ``graphs.run_traced`` runs the same blocks on a static state."""
    cfg = cfg.resolved(state.u.shape[-1])
    block = max(1, cfg.block_iters)
    s = state
    while _running(s, cfg.max_iter):
        s = _traced_block(s, loglike2, data, cfg,
                          min(block, cfg.max_iter - s.i))
    return s


def ns_finalize(state: _State, cfg: NSConfig) -> NSResult:
    """Weights, live-point contribution, information, and error."""
    R, L, D = state.u.shape
    cfg = cfg.resolved(D)
    like = state.u
    dtype = like.dtype
    max_iter = cfg.max_iter
    shift = state.lnl_shift
    lnx_tab, lnw_tab = _tables(cfg, L, like)

    n_dead = torch.clamp(state.n_deaths, max=max_iter)
    nd = n_dead.long()
    valid = torch.arange(max_iter, device=like.device)[None, :] < nd[:, None]
    dead_lnw = torch.where(valid, lnw_tab.expand(R, max_iter), _NEG)
    dead_lnl_s = torch.where(valid, state.dead_lnl, _NEG)
    # remaining prior volume split among the non-zombie live points
    n_live_eff = torch.clamp(L - state.pending, min=1).to(dtype)
    live_lnw = (lnx_tab[nd] - torch.log(n_live_eff))[:, None].expand(R, L)
    live_lnw = torch.where(state.zombie, _NEG, live_lnw)
    live_lnl_s = torch.where(state.zombie, _NEG, state.lnl)

    all_lnw = torch.cat([dead_lnw, live_lnw], dim=1)
    all_lnl = torch.cat([dead_lnl_s, live_lnl_s], dim=1)
    lnz_s = torch.logsumexp(all_lnw + all_lnl, dim=1)
    # H = sum(p * (lnl - lnZ)) on terms shifted by each run's best point:
    # a bright posterior lies 1e4-1e5 nats above ``shift``, where
    # sum(p * lnl_s) - lnz_s cancels in float32, and so do the rounded
    # sums lnw + lnl_s that p would be taken from
    keep = all_lnl > _NEG / 2
    lnl_t = torch.where(keep, all_lnl - torch.amax(all_lnl, dim=1,
                                                   keepdim=True), _NEG)
    lnwl_t = all_lnw + lnl_t
    lnz_t = torch.logsumexp(lnwl_t, dim=1, keepdim=True)
    h = torch.sum(torch.where(keep, torch.exp(lnwl_t - lnz_t)
                              * (lnl_t - lnz_t), 0.0), dim=1)
    # var(lnZ) ~ H * <d>, <d> = -lnX(n_dead) / n_dead (see the JAX package)
    mean_d = -lnx_tab[nd] / torch.clamp(n_dead, min=1).to(dtype)
    lnz_err = torch.sqrt(torch.clamp(h, min=0.0) * mean_d)
    max_loglike = torch.maximum(torch.amax(dead_lnl_s, dim=1),
                                torch.amax(live_lnl_s, dim=1)) + shift
    return NSResult(
        lnz=lnz_s + shift,
        lnz_err=lnz_err,
        h=h,
        lnl_shift=shift,
        n_dead=n_dead,
        ncall=state.ncall,
        converged=state.converged,
        dead_u=state.dead_u,
        dead_lnl=torch.where(valid, state.dead_lnl + shift[:, None], _NEG),
        dead_lnw=dead_lnw,
        live_u=state.u,
        live_lnl=torch.where(state.zombie, _NEG,
                             state.lnl + shift[:, None]),
        live_lnw=live_lnw,
        max_loglike=max_loglike,
        nlive=L,
        ndim=D,
        max_iter=max_iter,
    )


def _gather_rows(tree, idx, n_rows):
    """Rows ``idx`` of every per-run tensor of a tuple of tensors (leaves
    whose leading axis is not the run axis pass through)."""
    idx = torch.as_tensor(idx, dtype=torch.long)

    def g(x):
        if isinstance(x, torch.Tensor) and x.ndim >= 1 \
                and x.shape[0] == n_rows:
            return x[idx.to(x.device)]
        return x

    return tuple(g(x) for x in tree)


def _gather_state(state: _State, idx, n_rows) -> _State:
    vals = _gather_rows([getattr(state, f) for f in _RUN_FIELDS], idx,
                        n_rows)
    return dataclasses.replace(state, **dict(zip(_RUN_FIELDS, vals)))


def _scatter_state(acc: _State, cur: _State, idx) -> _State:
    """Write ``cur``'s run rows into the full-size accumulator ``acc`` at
    rows ``idx`` (``idx < 0`` dropped), in place: the host loop owns the
    accumulator.  Scalars (generator, counter, EMA) come from ``cur``."""
    idx = np.asarray(idx)
    keep = np.flatnonzero(idx >= 0)
    dst = torch.as_tensor(idx[keep], dtype=torch.long)
    src = torch.as_tensor(keep, dtype=torch.long)
    for f in _RUN_FIELDS:
        a = getattr(acc, f)
        a[dst.to(a.device)] = getattr(cur, f)[src.to(a.device)]
    return dataclasses.replace(acc, gen=cur.gen, i=cur.i, bounds=(),
                               acc_ema=cur.acc_ema)


def _strip_bounds(state: _State) -> _State:
    """Drop the cached bounding geometry (its arity differs between the
    regimes; no consumer needs it across programs)."""
    return dataclasses.replace(state, bounds=())


def _slim(bounds):
    """The slim ``(chol, mean, rmax)`` of a full 7-tuple."""
    return bounds[1][:, 0], bounds[0][:, 0], bounds[2][:, 0]


#: stable wrappers, so a graph captured for one call of ``run_nested``
#: serves the next call with the same likelihood (see ``graphs.py``)
_WRAPPERS = {}
_WRAPPERS_CAP = 16
_WRAPPERS_LOCK = threading.Lock()


def _memo(key, make):
    """The wrapper cached under ``key`` (built by ``make``), holding the
    objects whose ``id`` is in the key so no id is reused."""
    with _WRAPPERS_LOCK:
        if key not in _WRAPPERS:
            while len(_WRAPPERS) >= _WRAPPERS_CAP:
                _WRAPPERS.pop(next(iter(_WRAPPERS)))
            _WRAPPERS[key] = make()
        return _WRAPPERS[key][0]


def _normalize_loglike(loglike, data):
    """``loglike(u, data)`` from either form of the caller's likelihood,
    with a stable identity per likelihood."""
    if data is not None:
        return loglike
    return _memo(("plain", id(loglike)),
                 lambda: ((lambda u, _data: loglike(u)), loglike))


def _floored(loglike2, log_zero: float):
    """MultiNest's logZero: likelihoods at or below ``log_zero`` become
    the sampler's log-zero sentinel, so no such point is ever accepted
    or adds evidence (one wrapper per likelihood and floor)."""
    def make():
        def loglike_lz(u, d):
            v = loglike2(u, d)
            return torch.where(v > log_zero, v, _NEG)
        return loglike_lz, loglike2

    return _memo(("log_zero", id(loglike2), float(log_zero)), make)


def _apply_active(state: _State, active) -> _State:
    """Rows of ``active`` that are False are born done."""
    if active is not None:
        act_rows = torch.as_tensor(np.asarray(active, dtype=bool),
                                   device=state.u.device)
        state.done = state.done | ~act_rows
    return state


def run_nested(
    gen: torch.Generator,
    loglike: Callable,
    ndim: int,
    n_runs: int,
    config: NSConfig = NSConfig(),
    dtype=torch.float32,
    data=None,
    segment_iters: int = 0,
    compact: bool = True,
    active=None,
    mesh=None,
) -> NSResult:
    """Run ``n_runs`` independent nested-sampling fits in lockstep on
    ``gen.device``.

    ``loglike(u[..., n_runs, ndim]) -> [..., n_runs]`` includes the prior
    transform (or ``loglike(u, data)`` with ``data`` given).
    ``segment_iters=0`` (the default, as in the JAX package) runs the
    traced mode: blocks of ``block_iters`` candidate iterations and a
    masked slice fill, with neither regime switch nor compaction, until
    every run is done (``graphs.run_traced``: one captured CUDA graph per
    block on the card).  ``segment_iters > 0`` runs the host loop of
    bounded segments of at most ``segment_iters`` iterations instead:
    short candidate segments (``switch_iters``) while the acceptance EMA
    is healthy, then the kill+slice program, with zero-eval probes that
    switch back when the estimated acceptance recovers and a short
    probation segment confirms it; straggler runs are compacted into
    power-of-four batch classes.  ``active`` marks rows that are born
    done (padding of a partial batch).

    ``mesh`` (``parallel.make_mesh``) splits the runs into its dp rows'
    contiguous shares: each row runs them on its first device, in a
    thread of its own, with a generator seeded from one draw of ``gen``
    per row (a single row on ``gen``'s device uses ``gen`` itself, so a
    ``(1, 1)`` mesh is no mesh), and stops when its own runs are done.
    ``data`` (or a ``parallel.ShardedBatch`` of it) is split with the
    runs; ``loglike`` must accept points and data on every row's device.
    The results are joined in run order on ``gen.device``.
    """
    if mesh is None:
        return _run_nested(gen, loglike, ndim, n_runs, config, dtype, data,
                           segment_iters, compact, active)
    from nestfit_tpu_torch.parallel import mesh as _mesh
    from nestfit_tpu_torch.sampling import graphs

    def row(k, rows, devices, gen_k):
        d_k = _shard_data(data, k, rows, n_runs, devices[0])
        a_k = None if active is None else np.asarray(active)[rows]
        res = _run_nested(gen_k, loglike, ndim, rows.stop - rows.start,
                          config, dtype, d_k, segment_iters, compact, a_k,
                          shard=k)
        return res, graphs.thread_stats()

    parts = _mesh.run_shards(mesh, gen, n_runs, row)
    if not (segment_iters and segment_iters > 0):
        graphs.last_stats = sum((p[1] for p in parts), graphs.TracedStats())
    return _mesh.gather_rows([p[0] for p in parts], gen.device)


def _shard_data(data, k, rows, n_runs, device):
    """Row ``k``'s share ``rows`` of ``data`` on ``device``: its shard
    when ``data`` is a ``parallel.ShardedBatch``, else the ``rows`` of
    every per-run leaf."""
    from nestfit_tpu_torch.parallel import mesh as _mesh

    if isinstance(data, _mesh.ShardedBatch):
        if data.shard_channels or data.n_rows != n_runs \
                or (data.bounds[k], data.bounds[k + 1]) != (rows.start,
                                                            rows.stop):
            raise ValueError("the sharded data does not match the runs' dp "
                             "rows (shard it with shard_channels=False "
                             "over the same mesh)")
        return data.shards[k]
    return None if data is None else _mesh.shard_rows(data, rows, n_runs,
                                                      device)


def _run_nested(gen, loglike, ndim, n_runs, config, dtype, data,
                segment_iters, compact, active, shard=0, capture=True):
    """:func:`run_nested` on one device; ``shard`` is the dp row of a mesh
    run and ``capture=False`` keeps the traced blocks out of CUDA graphs
    (``graphs.run_traced``) and runs the segmented loop's units eagerly
    on the run's own tensors (``graphs.SegmentedRun`` otherwise)."""
    cfg = config.resolved(ndim)
    loglike2 = _normalize_loglike(loglike, data)
    if cfg.log_zero > -1e60:
        loglike2 = _floored(loglike2, cfg.log_zero)

    segmented = bool(segment_iters and segment_iters > 0)
    if segmented and not capture:
        return _run_segmented(gen, loglike2, ndim, n_runs, cfg, dtype, data,
                              segment_iters, compact, active, _Units(
                                  loglike2, cfg))
    from nestfit_tpu_torch.sampling import graphs

    with graphs.row_stream(gen.device, shard):
        if segmented:
            return _run_segmented(
                gen, loglike2, ndim, n_runs, cfg, dtype, data, segment_iters,
                compact, active, graphs.SegmentedRun(loglike2, cfg, shard,
                                                     gen))
        with span("ns.init"):
            state = ns_init(gen, loglike2, data, ndim, n_runs, cfg, dtype)
            state = _apply_active(state, active)
        state = graphs.run_traced(state, loglike2, data, cfg, shard, capture)
        count("ns.iterations", state.i)
        with span("ns.finalize"):
            return ns_finalize(state, cfg)


def _run_segmented(gen, loglike2, ndim, n_runs, cfg, dtype, data,
                   segment_iters, compact, active, units: _Units):
    """The segmented host loop of :func:`_run_nested`, its units of work
    run by ``units``.  ``cfg`` is resolved."""
    # ceff mode keeps rejection sampling alive by construction (the
    # adaptive shrink holds acceptance at its target): no regime switch
    auto = cfg.method == "auto" and not cfg.ceff
    mode = "slice" if cfg.method == "slice" else "cand"
    margin = 1.0 if cfg.fallback_repeats <= 3 else 0.6
    acc_thresh = cfg.cand_min_acc if cfg.cand_min_acc > 0 \
        else margin / (cfg.fallback_repeats * 2.6 + 0.6)

    with span("ns.init"):
        state = _apply_active(ns_init(gen, loglike2, data, ndim, n_runs,
                                      cfg, dtype), active)

    acc = None                            # full-size accumulator
    orig_idx = np.arange(n_runs)          # current row -> original run
    cur_data = data
    r_cur = n_runs
    iter_cap = cfg.max_iter
    auto_back = auto and cfg.switch_back and cfg.switch_back_every > 0
    n_back = 0         # completed switch-backs (drives probe backoff)
    probation = False  # first candidate segment after a switch-back
    probe_at = 0       # earliest iteration for the next probe
    # batch sizes the candidate program has run at: the JAX package only
    # switches back to a candidate program it has already compiled
    cand_sizes = set()
    while True:
        i = state.i
        done_np = to_host(state.done, "ns.done")
        if done_np.all() or i >= iter_cap:
            break
        active_rows = np.flatnonzero(~done_np)
        n_active = active_rows.size
        if compact and 0 < n_active and cfg.min_compact < r_cur:
            # jump to the smallest power-of-four class >= n_active, and
            # only when that shrinks the batch at least 4x
            tgt = cfg.min_compact
            while tgt < n_active:
                tgt *= 4
            if tgt <= r_cur // 4:
                with span("ns.compact", rows_from=r_cur, rows_to=tgt):
                    count("ns.compactions")
                    if acc is None:
                        acc = _strip_bounds(units.own(state))
                    else:
                        acc = _scatter_state(acc, state, orig_idx)
                    active_orig = orig_idx[active_rows]
                    pad = np.full(tgt - n_active, active_orig[0],
                                  dtype=np.int64)
                    sel = np.concatenate([active_orig, pad])
                    sel_cur = np.concatenate([
                        active_rows,
                        np.full(len(pad), active_rows[0], dtype=np.int64),
                    ])
                    new_bounds = _gather_rows(state.bounds, sel_cur, r_cur)
                    state = _gather_state(acc, sel, n_runs)
                    state.bounds = new_bounds
                    state.done = torch.as_tensor(
                        np.arange(tgt) >= n_active, device=state.u.device)
                    orig_idx = np.concatenate(
                        [active_orig, np.full(len(pad), -1, dtype=np.int64)])
                    cur_data = None if data is None else \
                        _gather_data(data, sel, n_runs)
                    r_cur = tgt
        if mode == "cand":
            step = min(cfg.switch_iters, segment_iters) if auto \
                else segment_iters
            if probation:
                step = min(step, 4)
            cand_sizes.add(r_cur)
            if _NS_DEBUG:
                t0 = _debug_clock(state)
            with span("ns.segment", mode="cand", i0=i, R=r_cur) as seg:
                state = ns_segment(state, loglike2, cur_data, cfg,
                                   min(i + step, iter_cap), units)
                seg.set(i1=state.i)
            count("ns.segments")
            if _NS_DEBUG:
                print(f"ns-debug: cand seg i={i}->{state.i} R={r_cur} "
                      f"wall={_debug_clock(state) - t0:.2f}s "
                      f"ncall_mean={_ncall_mean(state):.0f}", flush=True)
            if auto and len(state.bounds) == 7:
                acc_ema = float(to_host(state.acc_ema, "ns.acc_ema"))
                if _NS_DEBUG:
                    in_cube = float(to_host(state.bounds[5].float().mean(),
                                            "ns.debug"))
                    print(f"ns-debug: i={state.i} mode=cand "
                          f"acc_ema={acc_ema:.4f} "
                          f"in_cube={in_cube:.2f} "
                          f"done={_n_done(state)}", flush=True)
                # one-way switch once the union stops paying
                i_floor = max(2 * cfg.bound_every, 8)
                if state.i >= i_floor and acc_ema < acc_thresh:
                    state.bounds = _slim(state.bounds)
                    mode = "slice"
                    probe_at = state.i + cfg.switch_back_every * (
                        1 << min(n_back, 4))
                probation = False
        else:
            if auto_back and i >= probe_at:
                with span("ns.probe", i=i, R=r_cur):
                    state, est = ns_rebuild_bounds(state, cfg)
                    est = float(to_host(est, "ns.probe_est"))
                if _NS_DEBUG:
                    print(f"ns-debug: probe i={i} R={r_cur} "
                          f"est={est:.4f} thresh={acc_thresh:.4f} "
                          f"cand_ready={r_cur in cand_sizes}", flush=True)
                if r_cur in cand_sizes and est > (
                        cfg.switch_back_margin * acc_thresh):
                    # prime the EMA to exactly the break-even threshold;
                    # the probation segment then measures the real rate
                    state.acc_ema = torch.full_like(state.acc_ema,
                                                    acc_thresh)
                    mode = "cand"
                    probation = True
                    n_back += 1
                    continue
                state.bounds = _slim(state.bounds)
                probe_at = i + cfg.switch_back_every
            # short slice segments while compaction can still fire
            step_s = min(segment_iters, 64) if r_cur > cfg.min_compact \
                else segment_iters
            if _NS_DEBUG:
                t0 = _debug_clock(state)
            with span("ns.segment", mode="slice", i0=i, R=r_cur) as seg:
                state = ns_segment_slice(state, loglike2, cur_data, cfg,
                                         min(i + step_s, iter_cap), units)
                seg.set(i1=state.i)
            count("ns.segments")
            if _NS_DEBUG:
                print(f"ns-debug: slice seg i={i}->{state.i} R={r_cur} "
                      f"wall={_debug_clock(state) - t0:.2f}s "
                      f"done={_n_done(state)} "
                      f"ncall_mean={_ncall_mean(state):.0f}", flush=True)

    count("ns.iterations", state.i)
    state = units.close(state)
    with span("ns.finalize"):
        if acc is not None:
            state = _scatter_state(acc, state, orig_idx)
        return ns_finalize(_strip_bounds(state), cfg)


def _debug_clock(state):
    """The host clock once the state's device is idle (progress lines)."""
    if state.u.device.type == "cuda":
        torch.cuda.synchronize(state.u.device)
    return time.perf_counter()


def _ncall_mean(state):
    """Mean likelihood calls per row, as the JAX package's progress lines
    take it (NumPy's mean of the int32 counts)."""
    return to_host(state.ncall, "ns.debug").mean()


def _n_done(state):
    """Runs done (progress lines)."""
    return int(to_host(state.done.sum(), "ns.debug"))


def _gather_data(data, idx, n_rows):
    """Rows ``idx`` of a ``((data, noise), ...)``-structured data tree."""
    if isinstance(data, torch.Tensor):
        return _gather_rows((data,), idx, n_rows)[0]
    return tuple(_gather_data(d, idx, n_rows) for d in data)
