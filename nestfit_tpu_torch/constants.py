"""Physical constants and compile-time-style configuration.

TPU-native rebuild of the reference's compile-time constants
(reference: includes/model_includes.pxi:20-37).  The reference inlines
these with Cython ``DEF``; here they are plain module constants consumed
by jitted functions (constant-folded by XLA at trace time).

The reference's ``__APPROX`` toggle (fastexp tables, +-5 sigma channel
windows, Tex interpolation; model_includes.pxi:15-20) is a CPU-era
scalar optimization.  On TPU, dense ``exp`` over the full channel axis
is faster than any table lookup, so the default is exact evaluation.
"""

# Speed of light (reference: model_includes.pxi:27-28)
CKMS = 299792.458       # km/s
CCMS = 29979245800.0    # cm/s

# Physical constants in CGS from CODATA (model_includes.pxi:31-32)
H = 6.62607015e-27      # erg s, Planck constant
KB = 1.380649e-16       # erg/K, Boltzmann constant

# CMB temperature.  The reference switches on __NEW_CONST
# (model_includes.pxi:33-36); we expose both and default to the new one.
TCMB = 2.72548          # K, Fixsen (2009) ApJ 707 916F
TCMB_OLD = 2.7315       # K, legacy pyspeckit value

# Gaussian FWHM factor 2*sqrt(2*ln(2)) (reference: core/core.pyx:20)
FWHM = 2.3548200450309493
