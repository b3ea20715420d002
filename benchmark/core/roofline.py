"""Peaks of the card and the work of a likelihood call (K1,
``hf_chi2_fused``), the same whatever implements it.

A likelihood call of one point fits ``ncomp`` components, and for each
spectrum and hyperfine line evaluates one Gaussian opacity term per
channel: ``ncomp * sum(lines * channels)`` exponentials, with five
other floating-point operations each (difference, square, scale,
multiply-add).  It reads its parameters and writes one number (the
pixel's data row is shared by every point of the pixel).
The per-channel radiative terms are not counted, so the count is a
floor of the work.  Bound time is the longest of the exponentials at
the SFU's 16 per clock per SM (the CUDA programming guide, sm_90), the
operations at the float32 peak and the bytes at the memory bandwidth.
"""

import subprocess

import torch

FP32_PEAK = 67e12          # FLOP/s, H100 SXM, outside the tensor cores
HBM_BW = 3.35e12           # B/s
EXP_PER_CLK_SM = 16
FLOPS_PER_EXP = 5


def card():
    """The card's name, SM count, max SM clock [Hz] and power limit [W]
    (``nvidia-smi``, read now); clock and limit None if unreadable."""
    props = torch.cuda.get_device_properties(0)
    clock = limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm,power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.strip().split(",")
        clock, limit = float(out[0]) * 1e6, float(out[1])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return dict(name=torch.cuda.get_device_name(0),
                sms=props.multi_processor_count, clock_hz=clock,
                power_limit_w=limit)


def lines_x_channels(axes):
    """``sum(lines * channels)`` over a configuration's spectra."""
    return sum(a.n_lines * a.size for a in axes)


def k1_work(calls_by_ncomp, lxc, n_model):
    """``(exps, flops, bytes)`` of ``calls_by_ncomp`` likelihood calls,
    ``{ncomp: calls}``, of a model with ``n_model`` parameters a
    component."""
    exps = sum(n * c * lxc for n, c in calls_by_ncomp.items())
    nbytes = sum(4 * c * (n * n_model + 1) for n, c in calls_by_ncomp.items())
    return exps, FLOPS_PER_EXP * exps, nbytes


def bound_s(work, info):
    exps, flops, nbytes = work
    return max(exps / (EXP_PER_CLK_SM * info["sms"] * info["clock_hz"]),
               flops / FP32_PEAK, nbytes / HBM_BW)
