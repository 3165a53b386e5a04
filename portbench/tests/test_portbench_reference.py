"""The reference's frozen formulas against the program's own (a test may
import the program; the reference may not), and the frozen sweep bound
against hand counts."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import roofline
from portbench.reference import check, forward, instrument

from .conftest import BENCH, TINY_B5

CONFIGS = sorted((BENCH / "configs").glob("*.json"))


def _config(path):
    return json.loads(path.read_text())


@pytest.mark.parametrize("config", [_config(p) for p in CONFIGS]
                         + [TINY_B5], ids=lambda c: c["name"])
def test_banks_match_the_port(config):
    """The FSF and LSF banks at the configuration's own wavelengths and
    widths, the Moffat's slope included."""
    from deconv3d_tpu_torch import Cube
    from portbench.harness import instrument_of

    L = config["shape"][0]
    cube = Cube.from_data(np.zeros((L, 1, 1), np.float32),
                          crval=config["crval"], cdelt=config["cdelt"])
    fsf, lsf = instrument_of(config).kernel_banks(
        cube, config["fsf_size"], config["lsf_width"])
    np.testing.assert_allclose(instrument.fsf_bank(config), fsf, rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(instrument.lsf_bank(config), lsf, rtol=1e-12,
                               atol=0)


def _chromatic(L=9):
    return {"shape": [L, 7, 6], "crval": 4750.0, "cdelt": 1.25,
            "pixel_scale": 0.2, "fsf_size": 5, "lsf_width": 3,
            "fsf": {"kind": "moffat", "fwhm": 0.3, "beta": 2.6,
                    "fwhm_slope": 1e-4, "lambda_ref": 4750.0},
            "lsf": {"kind": "gaussian", "fwhm": 2.5}}


@pytest.mark.parametrize("block", [1, 4, 9])
def test_forward_model_matches_the_port(block):
    """model_block over λ-blocks == the port's ``convolve_cube`` (float64,
    λ-dependent FSF), asymmetric kernels included."""
    from deconv3d_tpu_torch.convolve import convolve_cube

    config = _chromatic()
    gen = torch.Generator().manual_seed(3)
    fsf = torch.as_tensor(instrument.fsf_bank(config))
    fsf = fsf * (1 + 0.3 * torch.rand(fsf.shape, generator=gen,
                                      dtype=torch.float64))
    lsf = torch.as_tensor(instrument.lsf_bank(config))
    clean = torch.randn((2, 9, 7, 6), generator=gen, dtype=torch.float64)
    want = torch.stack([convolve_cube(c, fsf, lsf) for c in clean])
    got = torch.cat([forward.model_block(clean[:, a:b], fsf, lsf, lo, hi, a)
                     for lo, hi in forward.blocks(9, block)
                     for a, b in [forward.reach(lo, hi, 3, 9)]], dim=1)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_quad_and_qvox_match_the_port():
    from deconv3d_tpu_torch import sampler
    from deconv3d_tpu_torch.ops.banded import precision_diag

    config = _chromatic()
    gen = torch.Generator().manual_seed(4)
    fsf = torch.as_tensor(instrument.fsf_bank(config))
    lsf = torch.as_tensor(instrument.lsf_bank(config))
    w_pad = torch.rand((9, 14, 14), generator=gen, dtype=torch.float64)
    quad = torch.cat([forward.quad_block(w_pad, fsf, lo, hi)
                      for lo, hi in forward.blocks(9, 4)])
    torch.testing.assert_close(quad, sampler._quad_conv(w_pad, fsf),
                               rtol=1e-12, atol=0)
    qvox = torch.cat([forward.qvox_block(quad, lsf, lo, hi)
                      for lo, hi in forward.blocks(9, 2)])
    torch.testing.assert_close(qvox, precision_diag(lsf, quad), rtol=1e-12,
                               atol=0)


def test_weights_round_to_bfloat16():
    var = torch.tensor([1.0, 3.0, 0.0, float("inf"), -1.0, float("nan")])
    w = instrument.weights(var)
    assert w.tolist()[2:] == [0.0] * 4
    assert w[0] == 1.0 and w[1] == torch.tensor(1 / 3).to(torch.bfloat16)


@pytest.mark.parametrize("name", ["tiny", "tiny_b5"])
def test_control_differs_from_the_reference_only_by_rounding(tiny, name):
    """The float64 control reads as the reference itself: every number 0
    but ``unmoved``, which is 1 (the reference samples nothing), with
    masked and NaN spaxels too."""
    root, _ = tiny
    config = json.loads((root / f"portbench/configs/{name}.json").read_text())
    from portbench import scene

    data, var, mask = scene.make_inputs(config, 9, "cpu")
    out = check.control_outputs(config, data, var, 2, "gibbs", 9,
                                dtype=torch.float64, mask=mask)
    nums = check.compare(config, data, var, out, mask=mask)
    assert nums["unmoved"] == 1.0
    assert nums.get("unswept_moved", 0.0) == 0.0
    assert ("unswept_moved" in nums) == (mask is not None)
    for k in ("fsf_err", "lsf_err", "weight_err", "quad_err", "qvox_err",
              "resid_err"):
        assert nums[k] == 0.0, k
    assert nums["chi2_err"] < 1e-15


def test_sweep_bound_hand_count():
    """A 1-chain MH sweep, f = 3, L = 4, S = 1, lw = 3, 4 valid spaxels,
    acceptance 0.5: flops and bytes counted by hand."""
    shapes = {"f": 3, "L": 4, "S": 1, "lw": 3, "n_valid": 4, "Hp": 8,
              "Wp": 8, "n_colors": 9, "ny": 2, "nx": 2, "sampler": "mh",
              "positivity": False}
    b = roofline.sweep_bound(shapes, 1, 0.5)
    patch = 9 * 4
    visits, committed = 4, 2.0
    flops = (visits * (patch * 3 + 4 * 2) + visits * 4 * (2 * 3 + 6)
             + committed * (patch * 3 + 4))
    nbytes = (2 * 64 * 16 + 64 * 16 + 4 * 16 + 2 * committed * 16
              + 4 * 3 * 4 + 1 * (4 + 9) * 4 + 2 * 9 * 4 * 4)
    assert b["flops"] == flops == 880.0
    assert b["bytes"] == nbytes == 3588.0
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    gibbs = roofline.sweep_bound({**shapes, "sampler": "gibbs"}, 2, 0.0)
    assert gibbs["flops"] == 8 * (patch * 3 + 8) + 8 * (
        4 * (6 + 3 + 12 + 9 + 1) + patch * 3)
