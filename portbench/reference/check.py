"""The numbers that decide ``correct``, and the control that must fail them.

:func:`compare` holds a run's outputs against the plain reference worked
out again from the configuration and the inputs the benchmark made:

``fsf_err``, ``lsf_err``
    max |bank − reference bank| / max |reference bank|: the FSF (the
    program's low-rank reconstruction, against the exact bank, chromatic
    where the configuration's FWHM has a slope) and the LSF its set-up
    derived.
``weight_err``
    max |w − w̃| / max w̃ over the padded weight cube: the bfloat16-valued
    inverse variances, which must match exactly.
``quad_err``, ``qvox_err``
    max relative error of Σ F² w̃ per spaxel and, for the exact-Gibbs
    sampler, of each voxel's conditional precision.
``resid_err``
    the worst chain's max |resid − (data − model(clean))|·√w̃ over the
    weighted voxels, in units of the noise: the sweep state at the
    window's end against the forward model of its own clean cube.
``chi2_err``
    the worst chain's |χ²_running − χ²| / χ², χ² = Σ w̃ (data −
    model(clean))² in float64.
``unmoved``
    the worst chain's share of the swept voxels (L × the swept spaxels,
    :func:`swept`) that are bit-identical at the window's start and end:
    a sampler that stops moving, or leaves chains of its batch out, reads
    1 there, and one that skips half of its tiles, of its λ-planes or of
    its swept spaxels reads ½.
``unswept_moved`` (only where the inputs leave spaxels unswept)
    the worst chain's share of the voxels of the spaxels never swept that
    differ at the window's start and end: 0 exactly, as they stay frozen.
``accept_dev`` (``sampler='mh'``)
    the worst chain's |acceptance over the window − the adaptive target|
    (``RunConfig.target_acceptance``), from the program's acceptance
    trace: an accept rule that takes every proposal or none reads
    1 − target or the target.

Every number is a largest error, so lower is better and each has an upper
limit.  The reference runs on the inputs' device in blocks of λ-planes.

The inputs mean what the sampler under test documents, written again
here: a NaN datum counts as 0 with zero weight; a masked spaxel, and a
spaxel whose every datum is NaN, gets zero weight and is never swept; a
spaxel whose whole footprint (the f × f spaxels its FSF reaches, on every
plane) has zero weight has a flat conditional and is never swept either.
"""

from __future__ import annotations

import math

import torch

from . import forward as fw
from . import instrument as ins

#: the adaptive MH target a traffic mix leaves at the port's default
TARGET_ACCEPTANCE = 0.234


def banks(config: dict, device, dtype=torch.float64):
    """(fsf [L, f, f], lsf [L, lw]) of the configuration in ``dtype``."""
    fsf = torch.as_tensor(ins.fsf_bank(config), device=device)
    lsf = torch.as_tensor(ins.lsf_bank(config), device=device)
    return fsf.to(dtype), lsf.to(dtype)


def geometry(config: dict) -> dict:
    """The sampler's documented padding: spaxel blocks of the FSF's size f,
    the clean cube on Yc × Xc = ⌈Y/f⌉f × ⌈X/f⌉f and the residual and
    weights on (Yc + f − 1) × (Xc + f − 1), the data at offset f // 2."""
    L, Y, X = (int(v) for v in config["shape"])
    f = int(config["fsf_size"])
    Yc, Xc = -(-Y // f) * f, -(-X // f) * f
    return {"L": L, "Y": Y, "X": X, "f": f, "h": f // 2, "Yc": Yc,
            "Xc": Xc, "Hp": Yc + f - 1, "Wp": Xc + f - 1}


def padded_weights(config: dict, variance: torch.Tensor, dtype, data=None,
                   mask=None):
    """The weights w̃ on the residual's padded grid, in ``dtype``: none
    where a datum of ``data`` is NaN or ``mask`` (``[Y, X]``, True =
    excluded) masks the spaxel."""
    g = geometry(config)
    w = ins.weights(variance, data, mask)
    out = torch.zeros((g["L"], g["Hp"], g["Wp"]), dtype=dtype,
                      device=variance.device)
    out[:, g["h"]:g["h"] + g["Y"], g["h"]:g["h"] + g["X"]] = w.to(dtype)
    return out


def swept(config: dict, w_pad: torch.Tensor, data: torch.Tensor,
          mask=None) -> torch.Tensor:
    """``[Y, X]`` bool: the spaxels a sweep visits.  Not those that
    ``mask`` masks, nor those whose every datum is NaN, nor those whose
    footprint holds no weight on any plane: the clean spaxel (y, x)
    reaches the padded weights' rows y … y + f − 1 and columns x … x + f
    − 1."""
    g = geometry(config)
    L, Y, X, f = g["L"], g["Y"], g["X"], g["f"]
    device = w_pad.device
    weighted = torch.zeros(w_pad.shape[1:], dtype=torch.bool, device=device)
    dead = torch.ones((Y, X), dtype=torch.bool, device=device)
    for lo, hi in fw.blocks(L):
        weighted |= (w_pad[lo:hi] > 0).any(dim=0)
        dead &= torch.isnan(data[lo:hi]).all(dim=0)
    reach = torch.nn.functional.max_pool2d(
        weighted[None, None].to(torch.float32), f, stride=1)[0, 0] > 0
    out = reach[:Y, :X] & ~dead
    return out if mask is None else out & ~mask


def _defined(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every NaN set to 0."""
    return torch.where(torch.isnan(x), torch.zeros_like(x), x)


def _rel_max(got, want) -> float:
    """max |got − want| / max |want|, inf where the shapes differ."""
    if got is None or tuple(got.shape) != tuple(want.shape):
        return math.inf
    scale = float(want.abs().max())
    err = float((got.to(want.device, want.dtype) - want).abs().max())
    return err / scale if scale > 0 else err


def compare(config: dict, data: torch.Tensor, variance: torch.Tensor,
            out: dict, dtype=torch.float64, mask=None) -> dict:
    """The numbers of the module's docstring for ``out``: ``fsf``, ``lsf``,
    ``w_pad``, ``quad``, optionally ``qvox``, and per chain (leading axis)
    ``clean`` and ``clean_start`` ``[C, L, Yc, Xc]``, ``resid`` ``[C, L,
    Hp, Wp]`` and ``chi2`` ``[C]``; for MH ``accept`` ``[C]`` (the
    window's acceptance) and its ``target``.  ``data`` and ``variance`` are the
    inputs ``[L, Y, X]`` both sides were given, ``mask`` the spatial mask
    ``[Y, X]`` (None: no spaxel masked).  Returns the numbers and, under
    ``per_chain``, the chain-wise ones."""
    g = geometry(config)
    L, Y, X, h = g["L"], g["Y"], g["X"], g["h"]
    device = data.device
    fsf, lsf = banks(config, device, dtype)
    w_pad = padded_weights(config, variance, dtype, data, mask)
    nums = {"fsf_err": _rel_max(out["fsf"], fsf),
            "lsf_err": _rel_max(out["lsf"], lsf),
            "weight_err": _rel_max(out["w_pad"], w_pad)}

    quad_ok = (tuple(out["quad"].shape) == (L, g["Yc"], g["Xc"])
               and nums["fsf_err"] != math.inf)
    want_qvox = out.get("qvox") is not None
    quad = (torch.empty((L, g["Yc"], g["Xc"]), dtype=dtype, device=device)
            if quad_ok else None)
    qerr, qscale = 0.0, 0.0
    for lo, hi in fw.blocks(L):
        if not quad_ok:
            break
        q = fw.quad_block(w_pad, fsf, lo, hi)
        quad[lo:hi] = q
        qerr = max(qerr, float((out["quad"][lo:hi].to(device, dtype)
                                - q).abs().max()))
        qscale = max(qscale, float(q.abs().max()))
    nums["quad_err"] = qerr / qscale if quad_ok and qscale else math.inf
    if want_qvox:
        if quad_ok and tuple(out["qvox"].shape) == tuple(quad.shape):
            verr, vscale = 0.0, 0.0
            for lo, hi in fw.blocks(L):
                v = fw.qvox_block(quad, lsf, lo, hi)
                verr = max(verr, float((out["qvox"][lo:hi].to(device, dtype)
                                        - v).abs().max()))
                vscale = max(vscale, float(v.abs().max()))
            nums["qvox_err"] = verr / vscale
        else:
            nums["qvox_err"] = math.inf
    del quad

    clean, resid = out["clean"], out["resid"]
    C = int(clean.shape[0])
    shapes_ok = (tuple(clean.shape[1:]) == (L, g["Yc"], g["Xc"])
                 and tuple(resid.shape[1:]) == (L, g["Hp"], g["Wp"])
                 and nums["fsf_err"] != math.inf
                 and nums["lsf_err"] != math.inf)
    visited = swept(config, w_pad, data, mask)
    n_swept = int(visited.sum())
    n_unswept = Y * X - n_swept
    if not shapes_ok:
        chains = {k: [math.inf] * C for k in ("resid_err", "chi2_err",
                                              "unmoved")}
        if n_unswept:
            chains["unswept_moved"] = [math.inf] * C
        if out.get("accept") is not None:
            chains["accept_dev"] = [math.inf] * C
        return {**nums, **{k: max(v) for k, v in chains.items()},
                "per_chain": chains}
    w = w_pad[:, h:h + Y, h:h + X]
    sw = torch.sqrt(w)
    chi2 = torch.zeros(C, dtype=torch.float64, device=device)
    rerr = torch.zeros(C, dtype=torch.float64, device=device)
    moved = torch.zeros(C, dtype=torch.int64, device=device)
    stray = torch.zeros(C, dtype=torch.int64, device=device)
    for lo, hi in fw.blocks(L):
        a, b = fw.reach(lo, hi, lsf.shape[1], L)
        src = clean[:, a:b, :Y, :X].to(device, dtype)
        r = _defined(data[lo:hi].to(dtype)) - fw.model_block(
            src, fsf, lsf, lo, hi, a)
        wb = w[lo:hi]
        chi2 += (wb * r * r).sum(dim=(1, 2, 3)).to(torch.float64)
        got = resid[:, lo:hi, h:h + Y, h:h + X].to(device, dtype)
        dev = ((got - r).abs() * sw[lo:hi]).masked_fill(wb == 0, 0)
        rerr = torch.maximum(rerr, dev.amax(dim=(1, 2, 3)).to(torch.float64))
        start = out["clean_start"][:, lo:hi, :Y, :X].to(device)
        diff = clean[:, lo:hi, :Y, :X].to(device) != start
        moved += (diff & visited).sum(dim=(1, 2, 3))
        if n_unswept:
            stray += (diff & ~visited).sum(dim=(1, 2, 3))
    unmoved = 1.0 - moved.double() / (L * max(n_swept, 1))
    running = out["chi2"].reshape(-1).to(device, torch.float64)
    chi2_err = (running - chi2).abs() / chi2
    chains = {"resid_err": rerr.tolist(), "chi2_err": chi2_err.tolist(),
              "unmoved": unmoved.tolist()}
    if n_unswept:
        chains["unswept_moved"] = (stray.double()
                                   / (L * n_unswept)).tolist()
    if out.get("accept") is not None:
        chains["accept_dev"] = [abs(float(a) - float(out["target"]))
                                for a in out["accept"]]
    return {**nums, **{k: max(v) for k, v in chains.items()},
            "per_chain": chains}


def judge(nums: dict, limits: dict):
    """(correct, compared): every number at or under its limit; a number
    without a limit, or a limit without its number, fails.  ``compared``
    maps each name to its value and limit, in ``limits``' order."""
    names = [k for k in nums if k != "per_chain"]
    compared = {k: {"value": nums.get(k, math.nan),
                    "limit": limits.get(k, math.nan)}
                for k in list(limits) + [k for k in names if k not in limits]}
    correct = all(not math.isnan(c["value"]) and not math.isnan(c["limit"])
                  and c["value"] <= c["limit"] for c in compared.values())
    return correct, compared


def chains_failed(nums: dict, limits: dict) -> int:
    """Chains that break a chain-wise limit, or all of them when a number
    of the set-up does."""
    per = nums["per_chain"]
    C = len(next(iter(per.values())))
    shared = [k for k in nums if k not in per and k != "per_chain"]
    if any(not nums[k] <= limits.get(k, math.nan) for k in shared):
        return C
    return sum(any(not per[k][c] <= limits.get(k, math.nan) for k in per)
               for c in range(C))


def control_outputs(config: dict, data: torch.Tensor,
                    variance: torch.Tensor, n_chains: int, sampler: str,
                    seed: int, target: float = TARGET_ACCEPTANCE,
                    dtype=torch.bfloat16, mask=None) -> dict:
    """The reference in the program's place, computed in ``dtype`` (one
    precision below the configuration's float32): its banks, weights,
    quad (and qvox for ``sampler='gibbs'``), and per chain a clean cube
    drawn from ``seed`` with the residual and χ² of that clean cube, all
    worked out in ``dtype``.  The reference samples nothing: its clean
    cube at the window's end is the one it started from, and for MH it
    has accepted no proposal (``target``: the adaptive target).
    ``mask`` as :func:`compare`'s."""
    g = geometry(config)
    L, Y, X, h = g["L"], g["Y"], g["X"], g["h"]
    device = data.device
    fsf, lsf = banks(config, device, dtype)
    w_pad = padded_weights(config, variance, dtype, data, mask)
    quad = torch.cat([fw.quad_block(w_pad, fsf, lo, hi)
                      for lo, hi in fw.blocks(L)])
    qvox = (torch.cat([fw.qvox_block(quad, lsf, lo, hi)
                       for lo, hi in fw.blocks(L)])
            if sampler == "gibbs" else None)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    clean = torch.zeros((n_chains, L, g["Yc"], g["Xc"]), dtype=dtype,
                        device=device)
    clean[:, :, :Y, :X] = torch.randn((n_chains, L, Y, X), generator=gen,
                                      device=device).to(dtype)
    resid = torch.zeros((n_chains, L, g["Hp"], g["Wp"]), dtype=dtype,
                        device=device)
    chi2 = torch.zeros(n_chains, dtype=dtype, device=device)
    w = w_pad[:, h:h + Y, h:h + X]
    for lo, hi in fw.blocks(L):
        a, b = fw.reach(lo, hi, lsf.shape[1], L)
        r = _defined(data[lo:hi].to(dtype)) - fw.model_block(
            clean[:, a:b, :Y, :X], fsf, lsf, lo, hi, a)
        resid[:, lo:hi, h:h + Y, h:h + X] = r
        chi2 += (w[lo:hi] * r * r).sum(dim=(1, 2, 3))
    return {"fsf": fsf, "lsf": lsf, "w_pad": w_pad, "quad": quad,
            "qvox": qvox, "clean": clean,
            "clean_start": clean.clone(), "resid": resid,
            "chi2": chi2, "target": target,
            "accept": [0.0] * n_chains if sampler == "mh" else None}
