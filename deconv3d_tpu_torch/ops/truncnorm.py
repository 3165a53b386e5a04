"""One-sided truncated-normal draws z ~ TN[α, ∞), exact at any depth.

Counterpart of ``deconv3d_tpu/ops/truncnorm.py``, with the same two
regions and switch, so the same uniforms give the same z up to the tail
solver's rounding:

  * α ≤ 2: the inverse CDF, z = Φ⁻¹(Φ(α) + u_body·(1 − Φ(α))), capped at
    α + 9 (where p rounds to 1).
  * α > 2: the root of log Φ(−z) = log Φ(−α) + log u_tail.

The tail.  The JAX function starts from an asymptote in the log survival
function alone and takes 4 Newton steps on log Φ(−z), each with a log of
the hazard.  Here the same root is solved for the excess d = z − α.  With
E(z) = log erfcx(z/√2) (log Φ(−z) = E(z) − z²/2 − log 2, and erfcx(x) =
exp(x²)·erfc(x) neither saturates nor cancels in float32 at any α),
the equation reads

    F(d) = (E(α + d) − E(α)) − d·(α + d/2) − log u_tail = 0,

with F'(d) = −h(α + d), h(z) = φ(z)/Φ(−z) = sqrt(2/π)/erfcx(z/√2) the
hazard.  The start d₀ = −2 log u / (α + sqrt(α² − 2 log u)) drops the slowly
varying E difference (exact as u → 1); F is concave and decreasing, so
Newton steps from d₀ ≥ d* fall monotonically onto the root, and
:data:`NEWTON_STEPS` = 2 reach it to 1.5e-7 relative in float64 over the
whole tail (worst just above α = 2; 1e-14 after 3) and to float32's
rounding in float32 (``tests/test_torch_truncnorm.py``).  A step
multiplies by erfcx instead of dividing by the hazard:
d ← d + F·erfcx((α + d)/√2)·sqrt(π/2).  Solving for d and not z keeps the
excess free of cancellation where α is large (d ≈ −log u / α).

The sweep kernels evaluate these very formulas (``csrc/gibbs_step.cuh``
``tail_excess``, ``body_normal``; CUDA's ``erfcxf``, ``logf``,
``normcdff``, ``normcdfinvf``, no approximate intrinsic), so the plain
sweep and the kernels agree to those functions' last bits.  The sweeps
give the transform the exact-Gibbs Box-Muller pair of each voxel (Philox
streams 2 and 3, ``ops/philox.py``): u_body = u1, u_tail = u2, so a
positivity run draws the same uniforms as one without.
"""

from __future__ import annotations

import math

import torch

TAIL_SWITCH = 2.0
NEWTON_STEPS = 2
_SQRT_HALF = math.sqrt(0.5)
_SQRT_PI_OVER_2 = math.sqrt(math.pi / 2.0)


def log_sf(z: torch.Tensor) -> torch.Tensor:
    """log Φ(−z) for z ≥ 0, from erfcx (no saturation at any z)."""
    return (torch.log(0.5 * torch.special.erfcx(z * _SQRT_HALF))
            - 0.5 * (z * z))


def tail_excess(alpha: torch.Tensor, log_u: torch.Tensor) -> torch.Tensor:
    """d = z − α for the root z of log Φ(−z) = log Φ(−α) + ``log_u``, α > 2
    (the module's tail solver)."""
    z0 = torch.sqrt(alpha * alpha - 2.0 * log_u)
    d = (-2.0 * log_u) / (alpha + z0)
    e_alpha = torch.log(torch.special.erfcx(alpha * _SQRT_HALF))
    for _ in range(NEWTON_STEPS):
        ez = torch.special.erfcx((alpha + d) * _SQRT_HALF)
        f = (torch.log(ez) - e_alpha) - d * (alpha + 0.5 * d) - log_u
        d = d + (f * ez) * _SQRT_PI_OVER_2
    return d


def _body(alpha: torch.Tensor, u_body: torch.Tensor) -> torch.Tensor:
    """The inverse-CDF draw, for α ≤ 2 (``alpha`` clamped there)."""
    cdf = torch.special.ndtr(alpha)
    p = cdf + u_body * (1.0 - cdf)
    # p rounds to 1 with probability ~1e-9 per float32 draw: cap there
    return torch.minimum(torch.special.ndtri(p), alpha + 9.0)


def excess(alpha: torch.Tensor, u_body: torch.Tensor,
           log_u_tail: torch.Tensor) -> torch.Tensor:
    """d = z − α of the draw z ~ TN[α, ∞) from u_body and log u_tail
    (elementwise, ``alpha`` a tensor of their shape): the sweeps' form,
    whose tail excess carries no rounding of α."""
    body = _body(torch.clamp(alpha, max=TAIL_SWITCH), u_body) - alpha
    tail = tail_excess(torch.clamp(alpha, min=TAIL_SWITCH), log_u_tail)
    return torch.where(alpha > TAIL_SWITCH, tail, body)


def transform_uniforms(alpha, u_body: torch.Tensor,
                       u_tail: torch.Tensor) -> torch.Tensor:
    """Elementwise map of two U(0, 1) draws to z ~ TN[α, ∞) (the JAX
    package's ``transform_uniforms``), in the uniforms' dtype."""
    dtype = u_body.dtype
    alpha = torch.broadcast_to(
        torch.as_tensor(alpha, dtype=dtype, device=u_body.device),
        u_body.shape)
    body = _body(torch.clamp(alpha, max=TAIL_SWITCH), u_body)
    a_hi = torch.clamp(alpha, min=TAIL_SWITCH)
    tail = a_hi + tail_excess(a_hi, torch.log(u_tail))
    return torch.where(alpha > TAIL_SWITCH, tail, body)


def trunc_normal(alpha: torch.Tensor, u_body: torch.Tensor,
                 u_tail: torch.Tensor) -> torch.Tensor:
    """:func:`transform_uniforms` of same-shaped tensors: on CUDA tensors
    one launch of ``trunc_normal_kernel`` (``csrc/gibbs_sweep.cu``), the
    sweep kernels' own device function elementwise, counted by
    ``trunc_normal.launches`` (a check of that arithmetic on the card: no
    sweep calls it); on CPU tensors the plain transform."""
    if alpha.device.type == "cpu" and u_body.device.type == "cpu" \
            and u_tail.device.type == "cpu":
        return transform_uniforms(alpha, u_body, u_tail)
    import ctypes

    from .. import _build

    for name, t in (("alpha", alpha), ("u_body", u_body), ("u_tail", u_tail)):
        if t.device.type != "cuda" or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.shape != alpha.shape:
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor "
                             f"of alpha's shape {tuple(alpha.shape)}")
    if not (alpha.device == u_body.device == u_tail.device):
        raise ValueError("alpha, u_body and u_tail must lie on one device")
    out = torch.empty_like(alpha)
    fn = _build.load_library().trunc_normal_launch
    with torch.cuda.device(alpha.device):
        stream = torch.cuda.current_stream(alpha.device).cuda_stream
        err = fn(*(ctypes.c_void_p(t.data_ptr())
                   for t in (alpha, u_body, u_tail, out)),
                 alpha.numel(), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"trunc_normal_launch failed: CUDA error {err}")
    trunc_normal.launches += 1
    return out


trunc_normal.launches = 0


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
