"""Philox4x32-10 of the torch port: known answers, uniforms, counter layout."""

import numpy as np
import pytest
import torch

from deconv3d_tpu_torch.ops import philox

M32 = 0xFFFFFFFF


@pytest.mark.parametrize(
    "counter, key, expected",
    [
        # Random123 known-answer vectors for philox4x32_10
        ((0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((M32, M32, M32, M32), (M32, M32),
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ],
)
def test_known_answers(counter, key, expected):
    out = philox.philox4x32([torch.tensor(c) for c in counter], key)
    assert tuple(int(o) for o in out) == expected


def test_vectorised_equals_scalar():
    """Broadcast counters give the same words as one-at-a-time calls."""
    lam = torch.arange(8)
    words = philox.philox4x32((lam, 3, 5, 7), (11, 13))
    for i in range(8):
        one = philox.philox4x32((i, 3, 5, 7), (11, 13))
        assert [int(w[i]) for w in words] == [int(w) for w in one]


def test_uniform_mapping_open_interval_never_half():
    edges = torch.tensor([0, 1 << 8, (1 << 31) - 1, 1 << 31, M32 - 1, M32])
    rand = torch.as_tensor(
        np.random.default_rng(0).integers(0, 1 << 32, 100_000), dtype=torch.int64
    )
    for bits in (edges, rand):
        u = philox.bits_to_uniform(bits)
        assert u.dtype == torch.float32
        assert bool(((u > 0) & (u < 1)).all())
        assert not bool((u == 0.5).any())
    # symmetric about 0.5: the complement of the bits mirrors u exactly
    u = philox.bits_to_uniform(rand)
    assert torch.equal(philox.bits_to_uniform(M32 - rand), 1.0 - u)


def test_tpu_mapping_rounds_to_half_and_one_in_float32():
    """The TPU kernel's k·2⁻²⁴ + 2⁻²⁵ (top 24 bits) in float32 hits 0.5
    and 1.0 — the reason the port maps the top 23 bits instead."""
    k = torch.tensor([1 << 23, (1 << 24) - 1], dtype=torch.int64)
    tpu = k.to(torch.float32) * 2.0**-24 + 2.0**-25
    assert tpu.tolist() == [0.5, 1.0]


def test_sweep_uniforms_layout():
    key, sweep, n_colors, nij, L = (7 << 32) | 5, 12, 3, 4, 10
    u = philox.sweep_uniforms(key, sweep, n_colors, nij, L)
    assert u.shape == (n_colors, nij, L + 1)
    k0, k1 = philox.key_words(key)
    assert (k0, k1) == (5, 7)
    c, ij, lam = 2, 3, 9
    words = philox.philox4x32((lam >> 2, sweep, c, ij), (k0, k1))
    assert float(u[c, ij, lam]) == float(
        philox.bits_to_uniform(words[lam & 3])
    )
    acc = philox.philox4x32((0, sweep, c, (1 << 24) | ij), (k0, k1))[0]
    assert float(u[c, ij, L]) == float(philox.bits_to_uniform(acc))
    # absolute-sweep keyed: another sweep or key draws other numbers
    assert not torch.equal(u, philox.sweep_uniforms(key, sweep + 1, n_colors, nij, L))
    assert not torch.equal(u, philox.sweep_uniforms(key + 1, sweep, n_colors, nij, L))


@pytest.mark.parametrize("Y, cuts", [(7, [(0, 7)]), (7, [(0, 3), (3, 5),
                                                          (5, 7)]),
                                     (10, [(0, 4), (4, 7), (7, 10)]),
                                     (5, [(2, 2), (0, 1), (4, 5)])])
def test_cube_normals_rows_are_the_whole_cubes_rows(Y, cuts, monkeypatch):
    """``cube_normals`` with ``rows`` = (y0, y1) is bit-equal to rows
    [y0, y1) of the whole cube's normals (the draws of a sharded direct
    solve), uneven and empty cuts too, with λ chunks of 6 that do not
    divide L; rows outside the cube raise."""
    monkeypatch.setattr(philox, "NORMALS_CHUNK_L", 6)
    key, sweep, L, X = (3 << 32) | 9, 5, 11, 6
    streams = (philox.STREAM_DRAW_U1, philox.STREAM_DRAW_U2)
    whole = philox.cube_normals(key, sweep, streams, L, Y, X,
                                dtype=torch.float64)
    for y0, y1 in cuts:
        got = philox.cube_normals(key, sweep, streams, L, Y, X,
                                  dtype=torch.float64, rows=(y0, y1))
        assert got.shape == (L, y1 - y0, X)
        assert torch.equal(got, whole[:, y0:y1])
    with pytest.raises(ValueError, match="rows"):
        philox.cube_normals(key, sweep, streams, L, Y, X, rows=(0, Y + 1))
