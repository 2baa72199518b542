"""Fixed 4-bit codebooks and shared-exponent (MX) helpers.

A re-derivation of the numeric formats supported by the reference
(facebookresearch/any4):

- ``int4``: uniform asymmetric grouped codes in [0, 15], centered by -8 at
  reconstruction (reference: tinygemm_lib/utils.py:27-67).
- ``nf4``: the 16-entry NormalFloat table (reference: kmeans.py:17).
- ``fp4`` (e2m1): 4-bit float, 1 sign / 2 exponent / 1 mantissa bits
  (reference: tinygemm_lib/mx/formats.py fp4_e2m1 params).
- ``mx4``: fp4_e2m1 element values with a shared per-group e8m0 exponent
  (reference: tinygemm_lib/utils.py:85-232, FloatDefs.cuh kMX4_Values).
- ``any4``: learned per-row 16-entry LUT (this module only hosts table
  plumbing; learning lives in any4/quant/kmeans.py).

All tables are plain numpy so they can be baked into jitted functions as
constants.
"""
from __future__ import annotations

import numpy as np

# NormalFloat-4 table (bitsandbytes NF4; reference kmeans.py:17). Index 0..15.
NF4_TABLE = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=np.float32,
)

# fp4_e2m1 value table in *sign-magnitude code order*: code = (sign<<3)|mag,
# mag 0..7 -> {0, .5, 1, 1.5, 2, 3, 4, 6}. Matches the MX4 layout the
# reference kernels use (FloatDefs.cuh kMX4_Values / utils.py:200-218), where
# code 8 is -0.0.
FP4_E2M1_TABLE = np.array(
    [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
     -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0],
    dtype=np.float32,
)

# bitsandbytes-style FP4 table (different code order than MX4: bnb uses
# {0, 0.0625?..}) -- the reference delegates fp4 to bitsandbytes quantize_fp4
# whose codebook is the e2m1 table scaled to absmax 1:
# value = fp4(code) / 6 so the largest magnitude is 1.0.
FP4_BNB_TABLE = FP4_E2M1_TABLE / 6.0

FP4_E2M1_MAX = 6.0   # max_norm of fp4_e2m1
FP4_E2M1_EMAX = 2    # largest unbiased exponent of e2m1

E8M0_BIAS = 127      # shared-exponent bias for MX scale (e8m0)

_TABLES = {
    "nf4": NF4_TABLE,
    "fp4": FP4_BNB_TABLE,
    "mx4": FP4_E2M1_TABLE,
}


def get_table(name: str) -> np.ndarray:
    """Return the fixed 16-entry codebook for a named 4-bit format."""
    try:
        return _TABLES[name]
    except KeyError:
        raise ValueError(f"unknown fixed 4-bit format {name!r}; "
                         f"have {sorted(_TABLES)}") from None
