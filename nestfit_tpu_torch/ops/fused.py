"""Fused likelihoods: kernels K1 (``csrc/hf_chi2.cu``) and K4
(``csrc/gauss_chi2.cu``).

Ports of ``nestfit_tpu/ops/fused.py::hf_chi2_fused`` and
``::gauss_chi2_fused``.  One launch synthesises one spectrum (a
hyperfine transition, or a Gaussian mixture) for every flat row and
reduces its squared residual against the row's data, so neither the
opacity nor the prediction ever reaches device memory.  K1 has a second
entry, :func:`hf_lnl_fused`: the whole ln-likelihood of a hyperfine
model in one launch, from the packed parameter rows, over every
transition, with the model's per-component step and the noise scaling
inside the launch.  Each wrapper launches its Hopper kernel for CUDA
tensors and runs its plain PyTorch version (:func:`hf_chi2_plain`,
:func:`hf_lnl_plain`, :func:`gauss_chi2_plain`) for CPU tensors.
"""

import ctypes
import dataclasses
from typing import Callable

import numpy as np
import torch

from nestfit_tpu_torch.constants import CKMS
from nestfit_tpu_torch.models import gaussian, hyperfine
from nestfit_tpu_torch.models.tables import Transition
from nestfit_tpu_torch.ops import _build

SOURCE = "hf_chi2.cu"
GAUSS_SOURCE = "gauss_chi2.cu"
MAX_COMP = 8     # kMaxComp in both sources
MAX_LINES = 192  # kMaxLines in hf_chi2.cu
MAX_TRANS = 4    # kMaxTrans in hf_chi2.cu
# the per-row steps hf_lnl_launch instantiates (its ``model``)
PREP_AMMONIA = 0
PREP_DIAZENYLIUM = 1

_LINE_TABLES = {}
_PREP_TABLES = {}
# 10 pointers, B, C, R, S, nhf, device, stream
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# model, theta, out, B, C, R, transitions, n_trans, device, stream
_LNL_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [
    ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p]


class _LnlTrans(ctypes.Structure):
    """``LnlTrans`` of ``hf_chi2.cu``: one transition of a launch."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "dnu", "t0", "tbg", "data", "noise", "lines", "prep")] + [
        (n, ctypes.c_int) for n in ("S", "nhf", "noise_stride", "n_prep")]


@dataclasses.dataclass(frozen=True)
class LnlModel:
    """What :func:`hf_lnl_fused` needs of a hyperfine model: the kernel's
    per-row step for it (``prep``, ``PREP_*``), its parameters per
    component, its transitions (``spec.trans_id`` 1-based), its plain
    per-component step ``components(spec, params) -> (trans, voff, tex,
    tau0, sigm)`` and the constants its kernel step reads per transition,
    ``constants(trans)``, a float32 NumPy array."""

    prep: int
    n_params: int
    transitions: tuple
    components: Callable
    constants: Callable
# voff, sigm, peak, data, dnu, out, B, C, R, S, fc, device, stream
_GAUSS_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _check_inputs(name, dev, inputs):
    """Raise unless every ``(label, tensor, shape)`` is a contiguous
    float32 tensor of that shape on ``dev``."""
    for label, x, shape in inputs:
        if x.device != dev or x.dtype != torch.float32 \
                or not x.is_contiguous() or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: {label} must be contiguous float32 {shape} "
                f"on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _cached(tables, trans, device, make):
    """``make()`` as a float32 tensor on ``device``, once per transition
    and device (the ref kept beside it keeps ``id(trans)`` unique)."""
    key = (id(trans), str(device))
    tab = tables.get(key)
    if tab is None:
        tab = torch.as_tensor(make(), device=device)
        tables[key] = (tab, trans)
        return tab
    return tab[0]


def line_table(trans: Transition, device) -> torch.Tensor:
    """``[f_j | rb_j | w_j]`` of ``trans`` as one float32 tensor
    ``[3 * nhf]``: ``f_j = hf_freq_j / c`` and ``rb_j = nu voff_j / c``,
    computed in float64 on the host and cast, as the TPU kernel folds
    them (cached per transition and device)."""
    def make():
        hf_freq = (1.0 - trans.voff / CKMS) * trans.nu
        return np.concatenate([hf_freq / CKMS, trans.nu * trans.voff / CKMS,
                               trans.tau_wts]).astype(np.float32)
    return _cached(_LINE_TABLES, trans, device, make)


def hf_chi2_plain(trans: Transition, dnu, t0, tbg, data, voff, tex,
                  tau_main, sigm):
    """Plain PyTorch version of :func:`hf_chi2_fused`: the
    ``models/hyperfine.py`` prediction, summed over components, then the
    squared residual against data row ``b % R`` summed over channels."""
    if data.ndim == 1:
        data = data[None]
    B = voff.shape[0]
    R, S = data.shape
    pred = hyperfine.hf_predict(trans, dnu, t0, tbg, voff, tex, tau_main,
                                sigm).sum(dim=-2)            # [B, S]
    resid = data[None] - pred.reshape(B // R, R, S)
    return torch.sum(resid * resid, dim=-1).reshape(B)


def hf_chi2_fused(trans: Transition, dnu, t0, tbg, data, voff, tex,
                  tau_main, sigm):
    """Summed squared residual ``[B]`` of one hyperfine transition.

    ``dnu``/``t0``/``tbg`` are ``[S]``, ``data`` is ``[R, S]`` (or
    ``[S]``), and ``voff``/``tex``/``tau_main``/``sigm`` are ``[B, C]``
    with ``B = T * R``: flat row ``b`` is held against data row
    ``b % R``.  CUDA tensors launch the kernel (float32, contiguous);
    CPU tensors take the plain version.
    """
    if data.ndim == 1:
        data = data[None]
    B, C = voff.shape
    R, S = data.shape
    if B % R:
        raise ValueError(f"batch {B} is no multiple of the {R} data rows")
    if voff.device.type == "cpu":
        _build.count_call(hf_chi2_fused)
        return hf_chi2_plain(trans, dnu, t0, tbg, data, voff, tex,
                             tau_main, sigm)
    dev = voff.device
    params = (voff, tex, tau_main, sigm)
    chans = (dnu, t0, tbg)
    _check_inputs("hf_chi2_fused", dev,
                  [("params", p, (B, C)) for p in params]
                  + [("channel terms", c, (S,)) for c in chans]
                  + [("data", data, (R, S))])
    if not 1 <= C <= MAX_COMP or trans.nhf > MAX_LINES:
        raise ValueError(f"hf_chi2_fused: {C} components / {trans.nhf} "
                         f"lines exceed the kernel's {MAX_COMP}/{MAX_LINES}")
    lines = line_table(trans, dev)
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    fn = _build.function(SOURCE, "hf_chi2_launch", _ARGTYPES)
    rc = fn(*(x.data_ptr() for x in params), data.data_ptr(),
            *(c.data_ptr() for c in chans), lines.data_ptr(), out.data_ptr(),
            B, C, R, S, trans.nhf, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "hf_chi2_fused")
    _build.count_launch(hf_chi2_fused)
    return out


hf_chi2_fused.launches = 0
hf_chi2_fused.counter = "k1.lnl_split"


def hf_lnl_plain(model: LnlModel, spectra, params):
    """Plain PyTorch version of :func:`hf_lnl_fused`: per spectrum, the
    model's per-component step, :func:`hf_chi2_plain` and the scaling by
    ``1 / (2 sigma^2)`` of data row ``b % R``, summed in spectrum order
    (the runner's per-transition path, in one function)."""
    B = params.shape[0]
    lnl = 0.0
    for spec in spectra:
        trans, voff, tex, tau0, sigm = model.components(spec, params)
        chi2 = hf_chi2_plain(trans, spec.dnu, spec.t0, spec.tbg, spec.data,
                             voff, tex, tau0, sigm)
        inv2v = 1.0 / (2.0 * spec.noise * spec.noise)
        if spec.noise.ndim:
            inv2v = inv2v.repeat(B // spec.noise.shape[0])
        lnl = lnl - chi2 * inv2v
    return lnl


def hf_lnl_fused(model: LnlModel, spectra, params):
    """Ln-likelihood ``[B]`` of the packed parameter rows ``params``
    ``[B, N * C]`` (parameter-major) over every spectrum of ``spectra``:
    ``-sum_t chi2_t[b] / (2 sigma_t[b % R]^2)``, flat row ``b`` held
    against data row ``b % R`` (``data`` ``[R, S_t]`` or ``[S_t]``,
    ``noise`` ``[R]`` or 0-d).  CUDA tensors: one launch of K1's
    one-launch kernel, which runs ``model``'s per-component step itself
    (float32, contiguous, every spectrum on ``params``' device); CPU
    tensors take the plain version.
    """
    B, P = params.shape
    if P % model.n_params:
        raise ValueError(f"{P} parameters is no multiple of "
                         f"{model.n_params}")
    C = P // model.n_params
    datas = [s.data if s.data.ndim > 1 else s.data[None] for s in spectra]
    R = datas[0].shape[0]
    if any(d.shape[0] != R for d in datas):
        raise ValueError("hf_lnl_fused: the spectra differ in data rows")
    if B % R:
        raise ValueError(f"batch {B} is no multiple of the {R} data rows")
    if params.device.type == "cpu":
        _build.count_call(hf_lnl_fused)
        return hf_lnl_plain(model, spectra, params)
    dev = params.device
    if not 1 <= C <= MAX_COMP or not 1 <= len(spectra) <= MAX_TRANS:
        raise ValueError(f"hf_lnl_fused: {C} components / {len(spectra)} "
                         f"transitions exceed the kernel's "
                         f"{MAX_COMP}/{MAX_TRANS}")
    trans = (_LnlTrans * len(spectra))()
    for i, (spec, data) in enumerate(zip(spectra, datas)):
        tr = model.transitions[spec.trans_id - 1]
        S = data.shape[1]
        if tr.nhf > MAX_LINES:
            raise ValueError(f"hf_lnl_fused: {tr.nhf} lines exceed the "
                             f"kernel's {MAX_LINES}")
        if spec.noise.numel() != 1 and tuple(spec.noise.shape) != (R,):
            raise ValueError(f"hf_lnl_fused: noise {tuple(spec.noise.shape)}"
                             f" is neither one value nor one per data row")
        _check_inputs("hf_lnl_fused", dev,
                      [("channel terms", getattr(spec, f), (S,))
                       for f in ("dnu", "t0", "tbg")]
                      + [("data", data, (R, S)),
                         ("noise", spec.noise, tuple(spec.noise.shape))])
        lines = line_table(tr, dev)
        prep = _cached(_PREP_TABLES, tr, dev,
                       lambda: np.asarray(model.constants(tr), np.float32))
        trans[i] = _LnlTrans(
            spec.dnu.data_ptr(), spec.t0.data_ptr(), spec.tbg.data_ptr(),
            data.data_ptr(), spec.noise.data_ptr(), lines.data_ptr(),
            prep.data_ptr(), S, tr.nhf, int(spec.noise.numel() != 1),
            prep.numel())
    _check_inputs("hf_lnl_fused", dev, [("params", params, (B, P))])
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    fn = _build.function(SOURCE, "hf_lnl_launch", _LNL_ARGTYPES)
    rc = fn(model.prep, params.data_ptr(), out.data_ptr(), B, C, R,
            ctypes.addressof(trans), len(spectra), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "hf_lnl_fused")
    _build.count_launch(hf_lnl_fused)
    return out


hf_lnl_fused.launches = 0
hf_lnl_fused.counter = "k1.lnl_fused"


def gauss_chi2_plain(rest_freq_over_c, dnu, data, voff, sigm, peak):
    """Plain PyTorch version of :func:`gauss_chi2_fused`: the
    ``models/gaussian.py`` mixture, then the squared residual against
    data row ``b % R`` summed over channels."""
    if data.ndim == 1:
        data = data[None]
    B = voff.shape[0]
    R, S = data.shape
    pred = gaussian.mixture(dnu, voff, sigm, peak, rest_freq_over_c)
    resid = data[None] - pred.reshape(B // R, R, S)
    return torch.sum(resid * resid, dim=-1).reshape(B)


def gauss_chi2_fused(rest_freq_over_c, dnu, data, voff, sigm, peak):
    """Summed squared residual ``[B]`` of the Gaussian mixture.

    ``rest_freq_over_c`` is ``rest_freq / c`` (folded in float64 and
    cast to float32 for the kernel), ``dnu`` is ``[S]``, ``data`` is
    ``[R, S]`` (or ``[S]``), and ``voff``/``sigm``/``peak`` are ``[B, C]``
    with ``B = T * R``: flat row ``b`` is held against data row
    ``b % R``.  CUDA tensors launch the kernel (float32, contiguous);
    CPU tensors take the plain version.
    """
    if data.ndim == 1:
        data = data[None]
    B, C = voff.shape
    R, S = data.shape
    if B % R:
        raise ValueError(f"batch {B} is no multiple of the {R} data rows")
    if voff.device.type == "cpu":
        return gauss_chi2_plain(rest_freq_over_c, dnu, data, voff, sigm,
                                peak)
    dev = voff.device
    params = (voff, sigm, peak)
    _check_inputs("gauss_chi2_fused", dev,
                  [("params", p, (B, C)) for p in params]
                  + [("dnu", dnu, (S,)), ("data", data, (R, S))])
    if not 1 <= C <= MAX_COMP:
        raise ValueError(f"gauss_chi2_fused: {C} components exceed the "
                         f"kernel's {MAX_COMP}")
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    fn = _build.function(GAUSS_SOURCE, "gauss_chi2_launch", _GAUSS_ARGTYPES)
    rc = fn(*(p.data_ptr() for p in params), data.data_ptr(),
            dnu.data_ptr(), out.data_ptr(), B, C, R, S,
            float(np.float32(rest_freq_over_c)), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "gauss_chi2_fused")
    _build.count_launch(gauss_chi2_fused)
    return out


gauss_chi2_fused.launches = 0
