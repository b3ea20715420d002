"""Inputs for K3 ``tapered_invert`` tests: intervals as the placement
prior hands them over, with the edge cases where rounding decides the
cell.  Shared by the CPU design test and the card tests; imports
neither JAX nor ``nestfit_tpu``."""

import numpy as np

F32 = np.float32

# The seed-1 element of chip_smoke.py's N2H+ forward check (second
# placement, sfact 0, on get_diazenylium_priors' flat voff grid), traced
# on an H100 (tools/trace_transform.py): u, v_lo, v_hi as float32 bits.
# (v_lo - xmin) / dx is 281.99997 by true division and 282.0 as a
# product with fl(1/dx); the kernel returned 0x4005c2a4 (cell 281), the
# reciprocal-based plain version 0x400651a4 (cell 282).
SEED1 = dict(u=0x3ee943b8, x_lo=0x3f0562fc, x_hi=0x40800000, sfact=0,
             kernel=0x4005c2a4, reciprocal=0x400651a4)


def f32_bits(bits):
    """A one-element float32 array with the given bit pattern."""
    return np.array([bits], dtype=np.uint32).view(F32)


def k3_inputs(size, xmin, xmax, dx, seed, n_random=600):
    """``(u, x_lo, x_hi)`` float32 inside the grid: ``n_random`` random
    intervals, then the edge cases -- bounds on cell boundaries and 1-2
    ulp either side, one-cell and empty intervals, narrow intervals
    near either end of the grid, swapped bounds, the whole grid -- and
    the seed-1 element."""
    rng = np.random.default_rng(seed)
    span = xmax - xmin
    lo, hi = [rng.uniform(xmin, xmin + 0.875 * span, n_random)], []
    hi.append(lo[0] + rng.uniform(0.000625, 0.75, n_random) * span)
    # cell boundaries xmin + k dx, and 1 and 2 ulp either side, as the
    # lower and as the upper bound
    edge = F32(xmin + rng.integers(1, size - 1, 120) * dx)
    for step in (-2, -1, 0, 1, 2):
        e = edge.copy()
        for _ in range(abs(step)):
            e = np.nextafter(e, F32(np.sign(step) * np.inf))
        lo += [e, e - rng.uniform(0.01, 3, e.size)]
        hi += [e + rng.uniform(0.01, 3, e.size), e]
    # one-cell and empty intervals
    k = rng.integers(0, size - 1, 80)
    a = xmin + (k + rng.uniform(0.05, 0.5, k.size)) * dx
    lo += [a, a]
    hi += [a + rng.uniform(0, 0.45, k.size) * dx, a]
    # narrow intervals (1-5 cells) near either end of the grid
    for left, right in ((xmin, xmin + 0.075 * span),
                        (xmin + 0.9 * span, xmin + 0.9875 * span)):
        a = rng.uniform(left, right, 200)
        lo.append(a)
        hi.append(a + rng.uniform(1, 5, a.size) * dx)
    # swapped bounds, the whole grid
    a = rng.uniform(xmin + span / 8, xmax - span / 8, 40)
    lo += [a + span / 16, [xmin, xmin]]
    hi += [a, [xmax, xmax - dx]]
    x_lo = np.clip(np.concatenate(lo), xmin, xmax).astype(F32)
    x_hi = np.clip(np.concatenate(hi), xmin, xmax).astype(F32)
    u = rng.uniform(size=x_lo.size).astype(F32)
    u[:6] = [0.0, 1.0, 1e-35, 0.5, np.nextafter(F32(1), F32(0)), 1e-7]
    return (np.append(u, f32_bits(SEED1["u"])),
            np.append(x_lo, f32_bits(SEED1["x_lo"])),
            np.append(x_hi, f32_bits(SEED1["x_hi"])))
