"""Transfer functions and gamut matrices, in numpy
(``jxl_coder_tpu/ops/color.py:19-242,343-352``).

The port's copy of the JAX module's numpy-expressible part: the transfer
function pairs (``:19-157``), ``TRC_TO_LINEAR`` / ``LINEAR_TO_TRC``, the
primaries, white points and gamut matrices (``:160-242``), the 3x3
conversion and luma rows and ``is_hdr_encoding``.  The tone map and
``hdr_to_sdr`` run on the device (``ops/tone.py``).  The JAX
module computes the transfer functions with ``jax.numpy`` in float32, so
each function here casts its input to float32 and computes in float32
with float32 constants, as ``jnp`` does with JAX's default 32-bit
types; the linear pair passes its input through untouched, as the
original's identity lambda does.  The originals run eagerly, one XLA
operation at a time, so nothing fuses; ``powf`` is glibc's powf, which
``jnp.power`` calls on the CPU (numpy's float32 power differs on ~20% of
values, ``ops/fp.py`` has the same copy in torch).  ``exp`` and ``log``
are correctly rounded float32; XLA's own are within one ulp of them.
Given a numpy float64 array, the originals' sRGB and BT.709 decodes run
in numpy float64 up to their final ``jnp.where``, which rounds to
float32: the copies do the same.  The host encoder's colour front
(``host/vardct/enc_real.py`` ``encoded_to_xyb``) and the float64 host
decoder's output encodings (``host/vardct/dec_real.py``) use them.
"""

from __future__ import annotations

import numpy as np

_F = np.float32

# glibc sysdeps/ieee754/flt-32: __powf_log2_data (invc, logc per
# subinterval), the log2 polynomial, __exp2f_data and its polynomial
_LOG2_TAB = np.array([float.fromhex(v) for v in (
    "0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2",
    "0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2",
    "0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2",
    "0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2",
    "0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2",
    "0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3",
    "0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3",
    "0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4",
    "0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5",
    "0x1.0000000000000p+0", "0x0.0p+0",
    "0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4",
    "0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3",
    "0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3",
    "0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2",
    "0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2",
    "0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2")]).reshape(16, 2)
_LOG2_POLY = [float.fromhex(v) for v in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0")]
_EXP2_TAB = np.array([
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
    0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
    0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
    0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
    0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
    0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
    0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
    0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540], np.int64)
_EXP2_POLY = [float.fromhex(v) for v in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1")]
_EXP2_SHIFT = float.fromhex("0x1.8p52") / 32
_EXP2_SHIFT_BITS = int(np.float64(_EXP2_SHIFT).view(np.int64))
_LOG2_OFF = 0x3f330000


def powf(x, y: float) -> np.ndarray:
    """float32 x ** float32(y) as glibc's powf rounds it (its float64
    log2 / exp2 evaluation, rounded once), for x >= 0; 0 ** y is 0 for
    y > 0, as powf gives it."""
    x = _f32(x)
    pos = x > 0
    ix = np.where(pos, x, _F(1.0)).view(np.int32).astype(np.int64)
    tmp = ix - _LOG2_OFF
    i = (tmp >> 19) & 15
    k = tmp >> 23
    z = (ix - k * (1 << 23)).astype(np.int32).view(np.float32).astype(
        np.float64)
    A = _LOG2_POLY
    r = z * _LOG2_TAB[i, 0] - 1.0
    y0 = _LOG2_TAB[i, 1] + k
    r2 = r * r
    p5 = A[0] * r + A[1]
    p3 = A[2] * r + A[3]
    r4 = r2 * r2
    q = A[4] * r + y0
    q = p3 * r2 + q
    logx = p5 * r4 + q
    xd = float(_F(y)) * logx
    kd = xd + _EXP2_SHIFT
    ki = kd.view(np.int64) - _EXP2_SHIFT_BITS
    rr = xd - (kd - _EXP2_SHIFT)
    s = (_EXP2_TAB[ki & 31] + ki * (1 << 47)).view(np.float64)
    C = _EXP2_POLY
    zz = C[0] * rr + C[1]
    out = C[2] * rr + 1.0
    out = zz * (rr * rr) + out
    return np.where(pos, (out * s).astype(np.float32), _F(0.0))


def exp(v) -> np.ndarray:
    return np.exp(_f32(v).astype(np.float64)).astype(np.float32)


def log(v) -> np.ndarray:
    return np.log(_f32(v).astype(np.float64)).astype(np.float32)


def _f32(v) -> np.ndarray:
    return np.asarray(v, np.float32)


def _where(cond, a, b):
    return np.where(cond, a, b).astype(np.float32)


# --------------------------------------------------------------------------
# Transfer functions (linear <-> encoded)

def _in_dtype(v):
    """The originals' arithmetic type before their first jnp call: a
    float64 numpy array stays float64, anything else is float32."""
    v = np.asarray(v)
    return v if v.dtype == np.float64 else v.astype(np.float32)


def srgb_to_linear(v):
    v = _in_dtype(v)
    c = v.dtype.type
    with np.errstate(invalid="ignore"):
        lo = v / c(12.92)
        hi = (powf(np.maximum((v + c(0.055)) / c(1.055), c(0.0)), 2.4)
              if c is np.float32 else ((v + 0.055) / 1.055) ** 2.4)
    return _where(v <= c(0.04045), lo, hi)


def linear_to_srgb(v):
    v = np.maximum(_f32(v), _F(0.0))
    return _where(v <= _F(0.0031308), v * _F(12.92),
                  _F(1.055) * powf(v, 1 / 2.4) - _F(0.055))


def bt709_to_linear(v):
    v = _in_dtype(v)
    c = v.dtype.type
    with np.errstate(invalid="ignore"):
        lo = v / c(4.5)
        hi = (powf(np.maximum((v + c(0.099)) / c(1.099), c(0.0)), 1 / 0.45)
              if c is np.float32 else ((v + 0.099) / 1.099) ** (1 / 0.45))
    return _where(v < c(0.081), lo, hi)


def linear_to_bt709(v):
    v = np.maximum(_f32(v), _F(0.0))
    return _where(v < _F(0.018), v * _F(4.5),
                  _F(1.099) * powf(v, 0.45) - _F(0.099))


def gamma_to_linear(v, gamma: float):
    return powf(np.maximum(_f32(v), _F(0.0)), gamma)


def linear_to_gamma(v, gamma: float):
    return powf(np.maximum(_f32(v), _F(0.0)), 1.0 / gamma)


# PQ (SMPTE ST 2084); normalised so 1.0 = 10000 nits.
_PQ_M1 = 2610.0 / 16384
_PQ_M2 = 2523.0 / 4096 * 128
_PQ_C1 = 3424.0 / 4096
_PQ_C2 = 2413.0 / 4096 * 32
_PQ_C3 = 2392.0 / 4096 * 32


def pq_to_linear(v):
    """Encoded PQ -> linear (1.0 == 10000 nits)."""
    v = np.maximum(_f32(v), _F(0.0))
    p = powf(v, 1.0 / _PQ_M2)
    num = np.maximum(p - _F(_PQ_C1), _F(0.0))
    den = _F(_PQ_C2) - _F(_PQ_C3) * p
    return powf(num / den, 1.0 / _PQ_M1)


def linear_to_pq(v):
    v = np.maximum(_f32(v), _F(0.0))
    p = powf(v, _PQ_M1)
    return powf((_F(_PQ_C1) + _F(_PQ_C2) * p)
                / (_F(1.0) + _F(_PQ_C3) * p), _PQ_M2)


# HLG (ARIB STD-B67)
_HLG_A = 0.17883277
_HLG_B = 1 - 4 * _HLG_A
_HLG_C = 0.5 - _HLG_A * np.log(4 * _HLG_A)


def hlg_to_linear(v):
    v = np.maximum(_f32(v), _F(0.0))
    with np.errstate(over="ignore"):
        return _where(v <= _F(0.5), v * v / _F(3.0),
                      (exp((v - _F(_HLG_C)) / _F(_HLG_A)) + _F(_HLG_B))
                      / _F(12.0))


def linear_to_hlg(v):
    v = np.maximum(_f32(v), _F(0.0))
    return _where(v <= _F(1.0 / 12), np.sqrt(_F(3.0) * v),
                  _F(_HLG_A) * log(np.maximum(_F(12.0) * v - _F(_HLG_B),
                                              _F(1e-12))) + _F(_HLG_C))


def dci_to_linear(v):
    return gamma_to_linear(v, 2.6)


def linear_to_dci(v):
    return linear_to_gamma(v, 2.6)


def _identity(v):
    return v


# TransferFunction wire values (headers.TransferFunction) -> functions
TRC_TO_LINEAR = {
    1: bt709_to_linear,       # BT709
    8: _identity,             # Linear
    13: srgb_to_linear,       # SRGB
    16: pq_to_linear,         # PQ
    17: dci_to_linear,        # DCI
    18: hlg_to_linear,        # HLG
}
LINEAR_TO_TRC = {
    1: linear_to_bt709,
    8: _identity,
    13: linear_to_srgb,
    16: linear_to_pq,
    17: linear_to_dci,
    18: linear_to_hlg,
}


# --------------------------------------------------------------------------
# Primaries / gamut matrices

ILLUMINANT_D65 = (0.3127, 0.3290)
ILLUMINANT_DCI = (0.314, 0.351)
ILLUMINANT_E = (1 / 3, 1 / 3)

PRIMARIES = {
    "srgb": ((0.640, 0.330), (0.300, 0.600), (0.150, 0.060)),
    "display_p3": ((0.680, 0.320), (0.265, 0.690), (0.150, 0.060)),
    "dci_p3": ((0.680, 0.320), (0.265, 0.690), (0.150, 0.060)),
    "bt2020": ((0.708, 0.292), (0.170, 0.797), (0.131, 0.046)),
    "bt601_525": ((0.630, 0.340), (0.310, 0.595), (0.155, 0.070)),
    "bt601_625": ((0.640, 0.330), (0.290, 0.600), (0.150, 0.060)),
    "adobe_rgb": ((0.640, 0.330), (0.210, 0.710), (0.150, 0.060)),
    "bt470m": ((0.670, 0.330), (0.210, 0.710), (0.140, 0.080)),
}


def _xy_to_xyz(x, y):
    return np.array([x / y, 1.0, (1 - x - y) / y])


def gamut_rgb_to_xyz(primaries, white) -> np.ndarray:
    """3x3 RGB -> XYZ from xy primaries and a white point."""
    m = np.stack([_xy_to_xyz(*p) for p in primaries], axis=1)
    w = _xy_to_xyz(*white)
    s = np.linalg.solve(m, w)
    return (m * s).astype(np.float64)


def gamut_xyz_to_rgb(primaries, white) -> np.ndarray:
    return np.linalg.inv(gamut_rgb_to_xyz(primaries, white))


def conversion_matrix(src: str, dst: str,
                      white=ILLUMINANT_D65) -> np.ndarray:
    """3x3 src-RGB -> dst-RGB (no adaptation when whites equal)."""
    a = gamut_rgb_to_xyz(PRIMARIES[src], white)
    b = gamut_xyz_to_rgb(PRIMARIES[dst], white)
    return (b @ a).astype(np.float32)


def luma_coeffs(primaries, white=ILLUMINANT_D65) -> np.ndarray:
    """Y row of RGB -> XYZ: the luma weights."""
    return gamut_rgb_to_xyz(primaries, white)[1].astype(np.float32)


# Wire-value maps (bitstream/headers.py Primaries / WhitePoint enums)
WIRE_PRIMARIES = {1: "srgb", 9: "bt2020", 11: "display_p3"}
WIRE_WHITE = {1: ILLUMINANT_D65, 10: ILLUMINANT_E, 11: ILLUMINANT_DCI}


def primaries_xy(ce):
    """xy primaries of a ColourEncoding (CUSTOM uses the signalled xys)."""
    if ce.primaries == 2 and ce.red is not None:  # CUSTOM
        return (ce.red.as_float(), ce.green.as_float(),
                ce.blue.as_float())
    return PRIMARIES[WIRE_PRIMARIES.get(ce.primaries, "srgb")]


def white_xy(ce):
    if ce.white_point == 2 and ce.white is not None:  # CUSTOM
        return ce.white.as_float()
    return WIRE_WHITE.get(ce.white_point, ILLUMINANT_D65)


def to_srgb_matrix(ce) -> np.ndarray:
    """3x3 f32 from the stream's primaries and white to sRGB / D65
    (hdr_to_sdr's gamut step)."""
    src = gamut_rgb_to_xyz(primaries_xy(ce), white_xy(ce))
    dst = gamut_xyz_to_rgb(PRIMARIES["srgb"], ILLUMINANT_D65)
    return (dst @ src).astype(np.float32)


def is_hdr_encoding(ce) -> bool:
    """True when the signalled colour encoding needs the SDR fallback
    for 8-bit outputs (PQ/HLG transfer or wide-gamut primaries)."""
    if ce is None or ce.want_icc:
        return False
    return (ce.transfer_function in (16, 18)
            or ce.primaries not in (1,))
