"""The inputs of a run, made from the configuration and ``--seed``.

Gaussian noise of standard deviation ``noise_sigma`` on every voxel,
drawn on the device by one ``torch.Generator`` call, plus each source of
``sources``: a flux at the voxel (⌊L·a/b⌋, ⌊Y·c/d⌋, ⌊X·e/g⌋) for
``"at": [[a, b], [c, d], [e, g]]``, so a scene keeps its layout when the
cube is scaled.  The variance cube is ``noise_sigma``² everywhere.  The
same seed gives the same cube on the same device.
"""

from __future__ import annotations

import torch


def make_inputs(config: dict, seed: int, device):
    """(data, variance) ``[L, Y, X]`` float32 on ``device``."""
    L, Y, X = (int(v) for v in config["shape"])
    sigma = float(config["noise_sigma"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    data = torch.randn((L, Y, X), generator=gen, device=device)
    data.mul_(sigma)
    for src in config["sources"]:
        (a, b), (c, d), (e, g) = src["at"]
        data[L * a // b, Y * c // d, X * e // g] += float(src["flux"])
    variance = torch.full_like(data, sigma * sigma)
    return data, variance
