"""One-sided truncated-normal draws z ~ TN[α, ∞), exact at any depth.

Counterpart of ``deconv3d_tpu/ops/truncnorm.py``, with the same two
regions, switch and Newton steps, so the same uniforms give the same z:

  * α ≤ 2: the inverse CDF, z = Φ⁻¹(Φ(α) + u_body·(1 − Φ(α))), capped at
    α + 9 (where p rounds to 1).
  * α > 2: the log survival function inverted, log Φ(−z) = log Φ(−α) +
    log u_tail, from the asymptotic guess z₀ = sqrt(2w − log 2w − log 2π),
    w = max(−t, 2.5), by 4 Newton steps z ← z + (log Φ(−z) − t)/h(z),
    h = φ(z)/Φ(−z) the hazard.

The JAX function evaluates the hazard as exp(log φ(z) − log Φ(−z)), which
cancels in float32 once z²/2 outgrows float32's 24 bits (z ≳ 100: the two
logs are −5e3 and more).  Here both come from the scaled complementary
error function erfcx(x) = exp(x²)·erfc(x), x = z/√2:

    log Φ(−z) = log(erfcx(x)/2) − z²/2,     h(z) = sqrt(2/π) / erfcx(x)

which is the same function in exact arithmetic (float64 agrees with the
JAX package to rounding, ``tests/test_torch_truncnorm.py``) and stays
accurate in float32 to α = 1e4.  The sweep kernels evaluate these very
formulas (``csrc/gibbs_step.cuh`` ``trunc_normal``; ``erfcxf``,
``normcdff``, ``normcdfinvf``), so the plain sweep and the kernels agree to
libm's last bits.

The sweeps give the transform the exact-Gibbs Box-Muller pair of each
voxel (Philox streams 2 and 3, ``ops/philox.py``): u_body = u1, u_tail =
u2, so a positivity run draws the same uniforms as one without.
"""

from __future__ import annotations

import math

import torch

TAIL_SWITCH = 2.0
NEWTON_STEPS = 4
_LOG_2PI = math.log(2.0 * math.pi)
_SQRT_HALF = math.sqrt(0.5)
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def log_sf(z: torch.Tensor) -> torch.Tensor:
    """log Φ(−z) for z ≥ 0, from erfcx (no saturation at any z)."""
    return (torch.log(0.5 * torch.special.erfcx(z * _SQRT_HALF))
            - 0.5 * (z * z))


def _tail_inverse(t: torch.Tensor) -> torch.Tensor:
    """Solve log Φ(−z) = t for z, t ≲ log Φ(−2)."""
    w = torch.clamp(-t, min=2.5)
    z = torch.sqrt(torch.clamp(2.0 * w - torch.log(2.0 * w) - _LOG_2PI,
                               min=0.25))
    for _ in range(NEWTON_STEPS):
        f = log_sf(z) - t
        h = _SQRT_2_OVER_PI / torch.special.erfcx(z * _SQRT_HALF)
        z = torch.clamp(z + f / torch.clamp(h, min=1e-30), min=1e-3)
    return z


def transform_uniforms(alpha, u_body: torch.Tensor,
                       u_tail: torch.Tensor) -> torch.Tensor:
    """Elementwise map of two U(0, 1) draws to z ~ TN[α, ∞) (the JAX
    package's ``transform_uniforms``), in the uniforms' dtype."""
    dtype = u_body.dtype
    alpha = torch.broadcast_to(
        torch.as_tensor(alpha, dtype=dtype, device=u_body.device),
        u_body.shape)
    a_lo = torch.clamp(alpha, max=TAIL_SWITCH)
    cdf = torch.special.ndtr(a_lo)
    p = cdf + u_body * (1.0 - cdf)
    # p rounds to 1 with probability ~1e-9 per float32 draw: cap there
    body = torch.minimum(torch.special.ndtri(p), a_lo + 9.0)
    t = log_sf(torch.clamp(alpha, min=TAIL_SWITCH)) + torch.log(u_tail)
    tail = _tail_inverse(t)
    return torch.where(alpha > TAIL_SWITCH, tail, body)


def truncated_standard_normal(generator: torch.Generator, alpha, shape,
                              dtype=torch.float64,
                              device=None) -> torch.Tensor:
    """z ~ N(0, 1) conditioned on z ≥ α (elementwise), from two uniforms in
    (0, 1) per draw of ``generator``."""
    tiny = torch.finfo(dtype).tiny
    u_body, u_tail = (
        torch.rand(shape, generator=generator, dtype=dtype,
                   device=device).clamp(min=tiny)
        for _ in range(2))
    return transform_uniforms(alpha, u_body, u_tail)
