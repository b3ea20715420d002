"""ctypes bindings of the native C++ engine ``cpp/nestfit_native.cpp``
(port of ``nestfit_tpu/native/bindings.py``, with the same public names).

The engine is an independent float64 implementation of the NH3 model,
of the prior transform (per-dimension PPF tables plus the joint
resolved-placement transform) and of a classical sequential nested
sampler: it holds the port's kernels and sampler against code that
shares nothing with them.

The library is built at first use, with the flags of ``cpp/Makefile``,
into ``nestfit_tpu_torch/_build/`` under a name that carries a hash of
the source and the flags; nothing is written into ``cpp/``.  Without a
C++ compiler :func:`available` is False; a compiler that fails on the
source raises.
"""

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from nestfit_tpu_torch.constants import H, KB, TCMB
from nestfit_tpu_torch.models.ammonia import BROT, CROT
from nestfit_tpu_torch.models.tables import AMMONIA_TRANSITIONS

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "cpp" / "nestfit_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall")

_LIB = None
_LOCK = threading.Lock()

_D = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_I = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")


def compiler():
    """The C++ compiler (``$CXX``, else ``g++``, ``c++`` or ``clang++``
    on the path), or None."""
    cands = [os.environ["CXX"]] if os.environ.get("CXX") else []
    for cxx in cands + ["g++", "c++", "clang++"]:
        path = shutil.which(shlex.split(cxx)[0])
        if path:
            return path
    return None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"nestfit_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; returns its path.
    Raises when there is no compiler or the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler found: the native library "
                           "cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [cxx, *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: concurrent builders agree
    return out


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        lib.nf_ns_gaussian.argtypes = [
            ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_double,
            ctypes.c_long, ctypes.c_uint64, _D,
        ]
        lib.nf_ns_spectral.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _D, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, _D, _D,
            ctypes.c_int,
            ctypes.c_int,
            _D, _D, _D, _D, _I, _D,
            _I, _D, _D,
            _D, _I, _I, _D, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_double, ctypes.c_long, ctypes.c_uint64,
            ctypes.c_double,
            _D, _D,
        ]
        lib.nf_amm_predict.argtypes = [
            _D, _D, _D, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, _D, _D,
            ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_double,
            _D, ctypes.c_int, _D,
        ]
        lib.nf_transform.argtypes = [
            ctypes.c_int, ctypes.c_int,
            _D, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, _D, _D,
            ctypes.c_int,
            _D, ctypes.c_int, _D,
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    """Whether the library loads: False without a C++ compiler; a build
    that fails raises."""
    if compiler() is None and not library_path().exists():
        return False
    return _load() is not None


def ns_gaussian(ndim, sigma, nlive=200, tol=0.1, max_iter=100000, seed=0):
    """Sequential C++ nested sampling on the analytic Gaussian problem.
    Returns a dict with lnz, lnz_err, h, n_dead, ncall, max_loglike."""
    lib = _load()
    out = np.zeros(6)
    lib.nf_ns_gaussian(ndim, sigma, nlive, tol, max_iter, seed, out)
    return dict(zip(
        ["lnz", "lnz_err", "h", "n_dead", "ncall", "max_loglike"], out))


def _chan_terms(xarr):
    xarr = np.ascontiguousarray(xarr, dtype=np.float64)
    t0 = H * xarr / KB
    tbg = 1.0 / np.expm1(t0 / TCMB)
    return xarr, t0, tbg


# ---------------------------------------------------------------------------
# PPF tables from the port's prior transformer.  The rows are evaluated in
# NumPy with the JAX package's arithmetic (float32 tables, float64 unit
# cube), so the tables equal the JAX binding's bit for bit; the port's own
# transform works in the float32 arithmetic of its kernels.
# ---------------------------------------------------------------------------

def _f32(t):
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)


def _ppf(dist, u):
    """``ppf_interp`` of the JAX package: ``y_lo + (y_hi - y_lo) frac``."""
    ppf = _f32(dist.ppf)
    scaled = u * (dist.size - 1)
    i_lo = np.clip(scaled.astype(np.int32), 0, dist.size - 2)
    y_lo, y_hi = ppf[i_lo], ppf[i_lo + 1]
    return y_lo + (y_hi - y_lo) * (scaled - i_lo)


def _tapered_invert(dist, u, x_lo, x_hi, s):
    """``tapered_interval_invert`` of the JAX package (``s`` in 0, 1, 2)."""
    t0, t1c, t2c, xax = (_f32(x) for x in (dist.t0, dist.t1c, dist.t2c,
                                           dist.xax))
    size = dist.size
    tiny = np.float32(1e-30)
    lo = np.minimum(x_lo, x_hi)
    hi = np.maximum(x_lo, x_hi)
    with np.errstate(invalid="ignore"):    # NaN bounds cast as in XLA
        i_lo = np.clip(((lo - dist.xmin) / dist.dx).astype(np.int32), 0,
                       size - 1)
        i_hi = ((hi - dist.xmin) / dist.dx).astype(np.int32)
    i_hi = np.where(i_hi == i_lo, i_lo + 1, i_hi)
    i_hi = np.clip(i_hi, 1, size)
    degenerate = (i_hi - i_lo) == 1
    ch = i_hi.astype(np.float32) - np.float32(dist.center)
    t0_lo, t1_lo, t2_lo = t0[i_lo], t1c[i_lo], t2c[i_lo]

    def g_raw(j):
        jj = np.clip(j, i_lo, i_hi - 1)
        d0 = t0[jj] - t0_lo
        if s == 0:
            return d0
        d1 = t1c[jj] - t1_lo
        if s == 1:
            return ch * d0 - d1
        d2 = t2c[jj] - t2_lo
        return ch * ch * d0 - np.float32(2.0) * ch * d1 + d2

    total = np.maximum(g_raw(i_hi - 1), tiny)

    def g_norm(j):
        g = g_raw(j) / total
        g = np.where(j < i_lo, np.float32(0.0), g)
        g = np.where(j >= i_hi, np.float32(1.0), g)
        return np.where(degenerate & (j >= i_lo), np.float32(1.0), g)

    u = np.maximum(u, tiny).astype(np.float32)
    lo_j = np.zeros(np.broadcast_shapes(u.shape, i_lo.shape), np.int32)
    hi_j = np.full_like(lo_j, size - 1)
    for _ in range(int(np.ceil(np.log2(size)))):
        mid = (lo_j + hi_j) // 2
        below = g_norm(mid) < u
        lo_j = np.where(below, mid + 1, lo_j)
        hi_j = np.where(below, hi_j, mid)
    i_hi_idx = np.clip(lo_j, 1, size - 1)
    y_lo = g_norm(i_hi_idx - 1)
    y_hi = g_norm(i_hi_idx)
    denom = np.maximum(y_hi - y_lo, tiny)
    return xax[i_hi_idx - 1] + (u - y_lo) * (np.float32(dist.dx) / denom)


def _apply_prior(prior, theta, ncomp):
    """One prior of the port's transformer on ``theta[n, n_param, ncomp]``
    (float64)."""
    from nestfit_tpu_torch.priors import priors as P

    if isinstance(prior, P.ConstantPrior):
        theta[:, prior.p_ix, :] = prior.value
    elif isinstance(prior, P.DuplicatePrior):
        v = _ppf(prior.dist, theta[:, prior.p_ix, :])
        theta[:, prior.p_ix, :] = v
        theta[:, prior.p_ix_dup, :] = v
    elif isinstance(prior, P.ResolvedPlacementPrior):
        dist = prior.vcen_prior.dist
        _apply_prior(prior.sigm_prior, theta, ncomp)
        ix_v, ix_s = prior.vcen_prior.p_ix, prior.sigm_prior.p_ix
        u = theta[:, ix_v, :].copy()
        if ncomp == 1:
            theta[:, ix_v, 0] = _ppf(dist, u[:, 0])
            return
        sig = theta[:, ix_s, :]
        min_seps = np.stack([np.zeros_like(sig[:, 0])] + [
            prior.sep_scale * np.sqrt(sig[:, i] * sig[:, i - 1])
            for i in range(1, ncomp)], axis=-1)
        sep_tot = np.sum(min_seps, axis=-1)
        v_range = dist.xmax - dist.xmin
        factor = np.where(sep_tot > v_range, v_range / sep_tot, 1.0)
        min_seps = min_seps * factor[:, None]
        sep_tot = sep_tot * factor
        v_lo = np.full_like(sep_tot, dist.xmin)
        v_hi = dist.xmax - sep_tot
        for i in range(ncomp):
            v_lo = v_lo + min_seps[:, i]
            v_hi = v_hi + min_seps[:, i]
            sfact = ncomp - 1 - i
            if sfact > 2:
                raise NotImplementedError(
                    "PPF tables of a placement prior at ncomp > 3")
            v = _tapered_invert(dist, u[:, i], v_lo, v_hi, sfact)
            theta[:, ix_v, i] = v
            v_lo = v
    elif type(prior) is P.Prior:
        theta[:, prior.p_ix, :] = _ppf(prior.dist, theta[:, prior.p_ix, :])
    else:
        raise NotImplementedError(
            f"PPF tables of a {type(prior).__name__}")


def ppf_tables_from_utrans(utrans, ncomp, n=2001):
    """Independent per-dimension PPF tables ``[n_param * ncomp, n]`` of the
    port's ``PriorTransformer``: row ``d`` is the transform of the unit
    cube whose every coordinate is ``linspace(0, 1, n)[i]``.

    Exact for independent priors only: the centroid dims of a
    ``ResolvedPlacementPrior`` depend on the sigma draws and on each
    other, so pass :func:`placement_spec_from_utrans` alongside and the
    engine applies the exact joint placement to them."""
    u = np.linspace(0.0, 1.0, n)
    theta = np.broadcast_to(u[:, None, None],
                            (n, utrans.n_param, ncomp)).copy()
    for prior in utrans.priors:
        _apply_prior(prior, theta, ncomp)
    return np.ascontiguousarray(
        theta.reshape(n, utrans.n_param * ncomp).T, dtype=np.float64)


def placement_spec_from_utrans(utrans):
    """The joint resolved-placement spec of the port's transformer for the
    engine: ``(p_voff, p_sigm, sep_scale, xax, pdf)`` in float64, or None
    when it holds no ``ResolvedPlacementPrior``."""
    from nestfit_tpu_torch.priors.priors import ResolvedPlacementPrior

    for pr in getattr(utrans, "priors", []):
        if isinstance(pr, ResolvedPlacementPrior):
            dist = pr.vcen_prior.dist
            return (
                int(pr.vcen_prior.p_ix),
                int(pr.sigm_prior.p_ix),
                float(pr.sep_scale),
                np.ascontiguousarray(dist.xax.detach().cpu().numpy(),
                                     dtype=np.float64),
                np.ascontiguousarray(dist.pdf.detach().cpu().numpy(),
                                     dtype=np.float64),
            )
    return None


def _placement_args(placement):
    if placement is None:
        return -1, -1, 0.0, np.zeros(1), np.zeros(1), 0
    p_voff, p_sigm, sep_scale, plc_xax, plc_pdf = placement
    return (p_voff, p_sigm, sep_scale,
            np.ascontiguousarray(plc_xax, dtype=np.float64),
            np.ascontiguousarray(plc_pdf, dtype=np.float64),
            plc_xax.shape[0])


def transform_native(utrans, ncomp, u, ppf=None, placement=None, n_tab=2001):
    """The engine's prior transform (per-dimension PPF tables plus the
    joint placement) of unit cubes ``u`` ``[n_pts, ndim]``: the path
    ``nf_ns_spectral`` integrates, for holding the port's transform."""
    lib = _load()
    n_params = utrans.n_param
    if ppf is None:
        ppf = ppf_tables_from_utrans(utrans, ncomp, n=n_tab)
    if placement is None:
        placement = placement_spec_from_utrans(utrans)
    u = np.ascontiguousarray(u, dtype=np.float64)
    if u.ndim != 2 or u.shape[1] != n_params * ncomp:
        raise ValueError(f"u must be [n, {n_params * ncomp}], got "
                         f"{u.shape}")
    theta = np.zeros_like(u)
    lib.nf_transform(ncomp, n_params,
                     np.ascontiguousarray(ppf, dtype=np.float64),
                     ppf.shape[1], *_placement_args(placement),
                     u, u.shape[0], theta)
    return theta


def ns_spectral_ammonia(spectra_data, ppf, ncomp=1, nlive=100, tol=1.0,
                        max_iter=200000, seed=0, placement=None,
                        max_wall_s=0.0):
    """Sequential C++ ammonia fit.

    ``spectra_data`` is ``[(xarr, data, noise, trans_id), ...]``, ``ppf``
    the ``[6 * ncomp, N]`` PPF tables, ``placement`` the joint placement
    spec (required for correct ``ncomp >= 2`` evidences under placement
    priors).  ``max_wall_s`` boxes the run's wall time (<= 0: unbounded);
    a boxed run that missed the tolerance returns ``truncated=True``."""
    lib = _load()
    if placement is not None and ncomp > 16:
        # the engine caps the placement spec at 16 components and would
        # integrate the (wider) independent-table prior instead
        raise ValueError(f"placement spec supports ncomp <= 16, got {ncomp}")
    xarr_cat, t0_cat, tbg_cat, data_cat = [], [], [], []
    n_chan, nu, nhf, voff_cat, wts_cat = [], [], [], [], []
    noise_l, para, level_n, ea = [], [], [], []
    for (xarr, data, noise, tid) in spectra_data:
        t = AMMONIA_TRANSITIONS[tid - 1]
        xa, t0, tbg = _chan_terms(xarr)
        xarr_cat.append(xa)
        t0_cat.append(t0)
        tbg_cat.append(tbg)
        data_cat.append(np.ascontiguousarray(data, dtype=np.float64))
        n_chan.append(xa.shape[0])
        nu.append(t.nu)
        nhf.append(t.nhf)
        voff_cat.append(t.voff)
        wts_cat.append(t.tau_wts)
        noise_l.append(float(noise))
        para.append(1 if t.para else 0)
        level_n.append(t.n)
        ea.append(t.ea)
    out = np.zeros(7)
    bestfit = np.zeros(6 * ncomp)
    lib.nf_ns_spectral(
        1, ncomp, 6,
        np.ascontiguousarray(ppf, dtype=np.float64), ppf.shape[1],
        *_placement_args(placement),
        len(spectra_data),
        np.concatenate(xarr_cat), np.concatenate(t0_cat),
        np.concatenate(tbg_cat), np.concatenate(data_cat),
        np.asarray(n_chan, dtype=np.int32),
        np.asarray(nu, dtype=np.float64),
        np.asarray(nhf, dtype=np.int32),
        np.concatenate(voff_cat), np.concatenate(wts_cat),
        np.asarray(noise_l, dtype=np.float64),
        np.asarray(para, dtype=np.int32),
        np.asarray(level_n, dtype=np.int32),
        np.asarray(ea, dtype=np.float64),
        BROT, CROT,
        nlive, tol, max_iter, seed,
        float(max_wall_s),
        out, bestfit,
    )
    res = dict(zip(["lnz", "lnz_err", "h", "n_dead", "ncall", "max_loglike"],
                   out[:6]))
    res["truncated"] = bool(out[6])
    res["bestfit"] = bestfit
    return res


def amm_predict_native(xarr, params, trans_id=1):
    """The engine's ammonia spectrum (an independent C++ path)."""
    lib = _load()
    t = AMMONIA_TRANSITIONS[trans_id - 1]
    xa, t0, tbg = _chan_terms(xarr)
    params = np.ascontiguousarray(params, dtype=np.float64)
    ncomp = params.shape[0] // 6
    pred = np.zeros_like(xa)
    lib.nf_amm_predict(
        xa, t0, tbg, xa.shape[0], t.nu, t.nhf, t.voff, t.tau_wts,
        1 if t.para else 0, t.n, t.ea, BROT, CROT, params, ncomp, pred,
    )
    return pred
