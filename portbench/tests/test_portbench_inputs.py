"""The scene's optional keys and the instrument's mapping: today's two
configurations give the inputs and problems they gave before the keys
existed, the keys mean what ``scene`` documents, every key of ``fsf`` and
``lsf`` reaches the port or is refused, and the reference's swept spaxels
are the port's."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from portbench import harness, scene
from portbench.reference import check

from .conftest import BENCH, TINY_B5

TODAY = ["muse_subcube_30x30x600", "muse_field_300x300x3681"]


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", TODAY)
def test_todays_inputs_are_the_old_formula(name):
    """A configuration without the optional keys, cut to 16 planes: the
    same bits as the formula the benchmark used before them."""
    config = _config(name)
    config["shape"] = [16] + config["shape"][1:]
    L, Y, X = config["shape"]
    seed, sigma = 2**31 + 5, float(config["noise_sigma"])
    gen = torch.Generator().manual_seed(seed)
    want = torch.randn((L, Y, X), generator=gen)
    want.mul_(sigma)
    for src in config["sources"]:
        (a, b), (c, d), (e, g) = src["at"]
        want[L * a // b, Y * c // d, X * e // g] += float(src["flux"])
    data, variance, mask = scene.make_inputs(config, seed, "cpu")
    assert torch.equal(data, want)
    assert torch.equal(variance, torch.full_like(want, sigma * sigma))
    assert mask is None


@pytest.mark.parametrize("name", TODAY)
def test_todays_configs_state_the_port_default_sizes(name):
    """``fsf_size`` and ``lsf_width`` passed to the port give the banks its
    default rules give: today's problems are unchanged."""
    from deconv3d_tpu_torch import Cube

    config = _config(name)
    cube = Cube.from_data(np.zeros((config["shape"][0], 1, 1), np.float32),
                          crval=config["crval"], cdelt=config["cdelt"])
    inst = harness.instrument_of(config)
    for got, want in zip(
            inst.kernel_banks(cube, config["fsf_size"], config["lsf_width"]),
            inst.kernel_banks(cube)):
        assert np.array_equal(got, want)


def test_instrument_of_carries_every_key():
    inst = harness.instrument_of(TINY_B5)
    assert (inst.fsf.fwhm, inst.fsf.beta) == (0.2, 2.6)
    assert (inst.fsf.fwhm_slope, inst.fsf.lambda_ref) == (2e-3, 4750.0)
    assert (inst.lsf.c2, inst.lsf.c1, inst.lsf.c0) == (5.866e-08, -0.0009187,
                                                       6.04)
    assert inst.pixel_scale == 0.2


@pytest.mark.parametrize("part,change,word", [
    ("fsf", {"fwhm_slop": 1e-5}, "fwhm_slop"),
    ("fsf", {"kind": "airy"}, "airy"),
    ("lsf", {"c3": 1e-12}, "c3"),
    ("lsf", {"kind": "gaussian"}, "gaussian"),
])
def test_instrument_of_refuses_a_key_it_does_not_map(part, change, word):
    config = {**TINY_B5, part: {**TINY_B5[part], **change}}
    with pytest.raises(ValueError, match=word):
        harness.instrument_of(config)


def test_the_optional_keys():
    """The per-voxel variance law, the noise scaled by it from the same
    normal draw, the masked rectangles and the NaN ones (every plane, and a
    range of planes)."""
    plain = {k: v for k, v in TINY_B5.items()
             if k not in ("variance", "mask", "nan")}
    plain["sources"] = []
    config = {**TINY_B5, "sources": []}
    data0, _, _ = scene.make_inputs(plain, 7, "cpu")
    data, variance, mask = scene.make_inputs(config, 7, "cpu")
    L, Y, X = config["shape"]
    lam = 4750.0 + 1.25 * np.arange(L)
    s = 2.5 / (2 * math.sqrt(2 * math.log(2)))
    sky = 1 + 4.0 * np.exp(-0.5 * ((lam - 4757.5) / s) ** 2)
    ok = ~torch.isnan(variance)
    u = variance[-1] / float(sky[-1])      # the last plane: NaN at x = 0
    assert float(u[:, 1:].min()) >= 0.5 and float(u[:, 1:].max()) <= 2.0
    want = torch.as_tensor(sky, dtype=torch.float32)[:, None, None] * u[None]
    torch.testing.assert_close(variance[ok], want[ok], rtol=1e-6, atol=0)
    torch.testing.assert_close(data[ok], (data0 * variance.sqrt())[ok],
                               rtol=1e-6, atol=0)
    want_mask = torch.zeros((Y, X), dtype=torch.bool)
    want_mask[2:4, 6:8] = True
    assert torch.equal(mask, want_mask)
    nan = torch.zeros((L, Y, X), dtype=torch.bool)
    nan[:, :, 0] = True
    nan[0:3, 5:7, 2:4] = True
    assert torch.equal(torch.isnan(data), nan)
    assert torch.equal(torch.isnan(variance), nan)


def test_reference_swept_spaxels_are_the_ports_valid_set():
    """Masked spaxels, all-NaN spaxels and a frozen one (finite data, no
    weight in its whole footprint) are never swept, on both sides; a
    spaxel with some NaN voxels is swept."""
    import deconv3d_tpu_torch as d3

    config = TINY_B5
    data, variance, mask = scene.make_inputs(config, 3, "cpu")
    mask[0:5, 0:5] = True
    mask[2, 2] = False
    variance[:, 2, 2] = math.nan
    cube = d3.Cube.from_data(data, variance=variance, mask=mask,
                             crval=config["crval"], cdelt=config["cdelt"])
    run = d3.Run(cube, harness.instrument_of(config), device="cpu",
                 fsf_size=config["fsf_size"], lsf_width=config["lsf_width"])
    w_pad = check.padded_weights(config, variance, torch.float64, data, mask)
    visited = check.swept(config, w_pad, data, mask)
    Y, X = config["shape"][1:]
    assert torch.equal(run.problem.valid[:Y, :X], visited)
    assert not visited[2, 2] and not visited[:, 0].any()
    assert visited[5, 2] and not visited[2, 6]
    torch.testing.assert_close(run.problem.w_pad.double(), w_pad, rtol=0,
                               atol=0)
