"""float32 arithmetic rounded as the JAX package's CPU backend rounds it.

The round-1 VarDCT encoder (``codec.encode_vardct_still``) quantises
with ``round(coeffs / steps)``, so a last-bit difference anywhere in its
front (sRGB -> linear -> XYB -> DCT) can move a quantised integer at a
rounding tie, and with it the bytes.  The port reproduces three
roundings of XLA's CPU backend, measured against ``jax.numpy`` on
x86-64 (0 mismatches in 3 million values each):

- ``powf``: ``jnp.power`` and ``jnp.cbrt`` call glibc's ``powf``, a
  float64 log2 / exp2 evaluation from small tables, rounded once to
  float32.  ``torch.pow`` in float32 differs from it on ~1.5% of
  values; this copy of the algorithm differs on none.
- ``fma``: XLA fuses ``a * b + c`` into one rounding.  The product of
  two float32 values is exact in float64, so ``fma`` rounds the float64
  sum once more to float32; that double rounding differs from a true
  fused multiply-add only when the float64 sum lies within 2^-53 of a
  float32 tie.
- ``div``: torch's CUDA division by a Python scalar multiplies by the
  scalar's reciprocal, and a Python scalar over a tensor is
  ``reciprocal(t) * s`` on every device; both round twice where
  ``jnp`` rounds once.
- ``matmul``: an f32 ``dot`` with a contracting size of 8 sums through
  four accumulators (terms j and j + 4 fused into accumulator j), then
  adds them pairwise; ``contract3`` is the sequential fused sum XLA
  takes for a contracting size of 3.

All of it is plain PyTorch and runs the same on the CPU and on a CUDA
device: float64 adds and multiplies are IEEE operations on both.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# glibc sysdeps/ieee754/flt-32: __powf_log2_data (invc, logc per
# subinterval of [0x3f330000, 2 * 0x3f330000), then the log2 polynomial)
_LOG2_TAB = [float.fromhex(v) for v in (
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
    "0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2")]
_LOG2_POLY = [float.fromhex(v) for v in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0")]
# __exp2f_data: bits(2^(i/32)) - (i << 47), then the exp2 polynomial
_EXP2_TAB = [
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
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540]
_EXP2_POLY = [float.fromhex(v) for v in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1")]
_EXP2_SHIFT = float.fromhex("0x1.8p52") / 32
_EXP2_SHIFT_BITS = int(np.float64(_EXP2_SHIFT).view(np.int64))
_LOG2_OFF = 0x3f330000


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    log2 = torch.tensor(_LOG2_TAB, dtype=torch.float64).view(16, 2)
    exp2 = torch.tensor(_EXP2_TAB, dtype=torch.int64)
    return log2.to(device), exp2.to(device)


def powf(x: torch.Tensor, y: float) -> torch.Tensor:
    """float32 x ** float32(y) as glibc's powf rounds it, for positive
    normal x (other lanes hold garbage; the callers select them away)."""
    log2_tab, exp2_tab = _tables(x.device)
    ix = x.contiguous().view(torch.int32).to(torch.int64)
    tmp = ix - _LOG2_OFF
    i = (tmp >> 19) & 15
    k = tmp >> 23
    z = (ix - k * (1 << 23)).to(torch.int32).view(torch.float32).double()
    A = _LOG2_POLY
    r = z * log2_tab[i, 0] - 1.0
    y0 = log2_tab[i, 1] + k.double()
    r2 = r * r
    p5 = A[0] * r + A[1]
    p3 = A[2] * r + A[3]
    r4 = r2 * r2
    q = A[4] * r + y0
    q = p3 * r2 + q
    logx = p5 * r4 + q
    xd = float(np.float32(y)) * logx
    kd = xd + _EXP2_SHIFT
    ki = kd.view(torch.int64) - _EXP2_SHIFT_BITS
    rr = xd - (kd - _EXP2_SHIFT)
    s = (exp2_tab[ki & 31] + ki * (1 << 47)).view(torch.float64)
    C = _EXP2_POLY
    zz = C[0] * rr + C[1]
    out = C[2] * rr + 1.0
    out = zz * (rr * rr) + out
    return (out * s).float()


def div(a, b) -> torch.Tensor:
    """a / b with one rounding on every device; a Python number on
    either side becomes a 0-dim tensor of the other's dtype and device."""
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, dtype=b.dtype, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=a.dtype, device=a.device)
    return a / b


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding (see the module note)."""
    return (a.double() * b.double() + c.double()).float()


def matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """float32 A @ B over a contracting size K divisible by 4, summed as
    XLA's CPU dot sums a K = 8 contraction: accumulator r fuses terms
    r, r + 4, ... in order; then (acc0 + acc1) + (acc2 + acc3)."""
    K = A.shape[-1]
    if K % 4 or B.shape[-2] != K:
        raise ValueError(f"contracting size {K}: expected a multiple of 4")
    acc = [A[..., :, r:r + 1] * B[..., r:r + 1, :] for r in range(4)]
    for j in range(4, K):
        acc[j % 4] = fma(A[..., :, j:j + 1], B[..., j:j + 1, :], acc[j % 4])
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def contract3(M: np.ndarray, v: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_j M[i, j] * v[j] for a 3x3 float32 matrix and (3, ...)
    planes, as XLA's CPU dot sums a K = 3 contraction (sequential, fused)."""
    M = np.asarray(M, np.float32)
    out = []
    for i in range(3):
        acc = float(M[i, 0]) * v[0]
        for j in (1, 2):
            acc = (float(M[i, j]) * v[j].double() + acc.double()).float()
        out.append(acc)
    return torch.stack(out)
