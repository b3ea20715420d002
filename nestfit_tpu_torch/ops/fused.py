"""Fused likelihoods: kernels K1 (``csrc/hf_chi2.cu``) and K4
(``csrc/gauss_chi2.cu``).

Ports of ``nestfit_tpu/ops/fused.py::hf_chi2_fused`` and
``::gauss_chi2_fused``.  One launch synthesises one spectrum (a
hyperfine transition, or a Gaussian mixture) for every flat row and
reduces its squared residual against the row's data, so neither the
opacity nor the prediction ever reaches device memory.  Each wrapper
launches its Hopper kernel for CUDA tensors and runs its plain PyTorch
version (:func:`hf_chi2_plain`, :func:`gauss_chi2_plain`) for CPU
tensors.
"""

import ctypes

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

_LINE_TABLES = {}
# 10 pointers, B, C, R, S, nhf, device, stream
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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


def line_table(trans: Transition, device) -> torch.Tensor:
    """``[f_j | rb_j | w_j]`` of ``trans`` as one float32 tensor
    ``[3 * nhf]``: ``f_j = hf_freq_j / c`` and ``rb_j = nu voff_j / c``,
    computed in float64 on the host and cast, as the TPU kernel folds
    them (cached per transition and device)."""
    key = (id(trans), str(device))
    tab = _LINE_TABLES.get(key)
    if tab is None:
        hf_freq = (1.0 - trans.voff / CKMS) * trans.nu
        host = np.concatenate([hf_freq / CKMS, trans.nu * trans.voff / CKMS,
                               trans.tau_wts]).astype(np.float32)
        tab = torch.as_tensor(host, device=device)
        _LINE_TABLES[key] = (tab, trans)   # the ref keeps id() unique
        return tab
    return tab[0]


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
    hf_chi2_fused.launches += 1
    return out


hf_chi2_fused.launches = 0


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
    gauss_chi2_fused.launches += 1
    return out


gauss_chi2_fused.launches = 0
