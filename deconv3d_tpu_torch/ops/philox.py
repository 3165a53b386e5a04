"""Counter-based Philox4x32-10 in plain torch — the sampler's random bits.

The JAX package's kernels draw from the TPU's hardware PRNG, whose bits no
other device reproduces.  The port uses Philox4x32-10 (Salmon et al., SC'11,
"Parallel random numbers: as easy as 1, 2, 3"), a counter-based generator:
every 128-bit output is a pure function of a 128-bit counter and a 64-bit
key, so any draw can be recomputed anywhere — in this module on tensors, and
inside the CUDA sweep kernel (``csrc/philox.cuh``), bit for bit.

Uint32 words live in int64 tensors masked to 32 bits; the 32×32→64-bit
products are split into 16-bit halves so that no intermediate leaves int64.

Counter layout of the MH sweep (one 4-word block per counter):

    key     = (chain key & 0xffffffff, chain key >> 32)
    counter = (λ >> 2, ABSOLUTE sweep, color, stream << 24 | spaxel row ij)

word ``λ & 3`` of the block is the jump uniform of wavelength λ (stream 0);
word 0 of the stream-1 block at λ = 0 is the accept uniform.  The exact-Gibbs
sweep draws its Box-Muller pair (u1, u2) of every (color, spaxel, λ) from
streams 2 and 3 in the same layout (with positivity the same pair feeds the
truncated-normal transform, ``ops/truncnorm.py``), the ``gibbs_block``
sweep its pair from streams 7 and 8.

The coarse pattern passes (``ops/coarse.py``), which run after the sweeps
of absolute sweep ``s`` (a multiple of ``coarse_every``), key their draws
by that same ``s`` and a slot = entry << 8 | j in word 2, where entry is
the pass's constants entry and j the pattern (global pass) or the
checkerboard color (anchor passes):

    counter = (λ >> 2, s, entry << 8 | j, stream << 24 | anchor)

The global pass draws the normal of pattern j's spectrum entry λ at anchor
0, the anchor passes the normal of (λ, anchor I·nx + J); both by
Box-Muller, sqrt(−2 log u1)·cos(2π u2), u1 from stream 4 and u2 from
stream 5, word ``λ & 3`` as above.  An anchor pass's accept uniform is
word 0 of the stream-6 block at λ = 0.  The direct sampler's draw at
absolute sweep s takes one normal per voxel of the cube
(:func:`cube_normals`), counter (λ >> 2, s, 0, stream << 24 | y·X + x):
z from streams 9 and 10, the ridge prior's z2 from 11 and 12.  Keying by the absolute sweep makes
any segmentation of a run, and any resume, draw the identical numbers (the
tiled TPU kernel keys its streams the same way,
``deconv3d_tpu/ops/pallas_tiled.py``; the JAX package folds the absolute
sweep into the key of its passes, ``deconv3d_tpu/sampler.py:1395``).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
ROUNDS = 10

#: stream ids of the sweeps' draws (high byte of counter word 3)
STREAM_JUMP = 0
STREAM_ACCEPT = 1
STREAM_NORMAL_U1 = 2
STREAM_NORMAL_U2 = 3
#: stream ids of the coarse passes' draws
STREAM_PASS_U1 = 4
STREAM_PASS_U2 = 5
STREAM_PASS_ACCEPT = 6
#: stream ids of the gibbs_block sweep's Box-Muller pairs
STREAM_BLOCK_U1 = 7
STREAM_BLOCK_U2 = 8
#: stream ids of the direct sampler's draws: the data perturbation z and
#: the ridge prior's z2
STREAM_DRAW_U1 = 9
STREAM_DRAW_U2 = 10
STREAM_PRIOR_U1 = 11
STREAM_PRIOR_U2 = 12

#: λ-planes of Philox blocks per chunk of :func:`cube_normals` (bounds its
#: int64 temporaries at a full MUSE field)
NORMALS_CHUNK_L = 256


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of the 64-bit product ``a · m`` (a < 2³²)."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    m_hi, m_lo = m >> 16, m & 0xFFFF
    low = a_lo * m_lo
    mid = a_hi * m_lo + a_lo * m_hi            # < 2³³
    low_full = low + ((mid & 0xFFFF) << 16)    # < 2³³
    lo = low_full & M32
    hi = (a_hi * m_hi + (mid >> 16) + (low_full >> 32)) & M32
    return hi, lo


def philox4x32(counter, key):
    """Philox4x32-10 of ``counter`` (4 word tensors) under ``key`` (2 words).

    Words are int64 tensors (or ints) holding values in [0, 2³²); they
    broadcast against each other.  Returns the 4 output words.
    """
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = int(key[0]) & M32, int(key[1]) & M32
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & M32
            k1 = (k1 + PHILOX_W1) & M32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words → float32 uniforms (2k+1)·2⁻²⁴, k = the top 23 bits.

    Every value is exact in float32, lies in (0, 1), is never 0.5, and the
    set is symmetric about 0.5 (so tan(π(u − ½)) is a symmetric Cauchy
    draw).  The TPU kernel's k·2⁻²⁴ + 2⁻²⁵ on the top 24 bits needs 25
    significant bits above 0.5: evaluated in float32 it rounds half to even
    and returns exactly 0.5 and 1.0 for two of its 2²⁴ inputs.
    """
    k = (bits >> 9).to(torch.float32)
    return (2.0 * k + 1.0) * 2.0 ** -24


def key_words(key: int):
    """(k0, k1) uint32 words of a 64-bit chain key."""
    key = int(key)
    return key & M32, (key >> 32) & M32


def _slot_uniforms(key: int, sweep: int, slots: torch.Tensor, nij: int,
                   L: int, stream: int, row0: int = 0) -> torch.Tensor:
    """``[len(slots), nij, L]`` uniforms of one stream: word ``λ & 3`` of
    the block at counter (λ >> 2, sweep, slot, stream << 24 | ij), spaxel
    rows ij = row0 .. row0 + nij − 1."""
    dev = slots.device
    lam = torch.arange(L, dtype=torch.int64, device=dev)
    slot = slots.to(torch.int64)[:, None, None]
    ij = torch.arange(row0, row0 + nij, dtype=torch.int64,
                      device=dev)[None, :, None]
    words = philox4x32(
        (lam >> 2, sweep & M32, slot, (stream << 24) | ij), key_words(key)
    )
    stacked = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    bits = torch.gather(
        stacked, -1, (lam & 3).expand(len(slots), nij, L)[..., None]
    )[..., 0]
    return bits_to_uniform(bits)


def _lambda_uniforms(key: int, sweep: int, n_colors: int, nij: int, L: int,
                     stream: int, device=None, row0: int = 0) -> torch.Tensor:
    """``[n_colors, nij, L]`` uniforms of one stream, slot = color."""
    dev = torch.device(device) if device is not None else None
    colors = torch.arange(n_colors, dtype=torch.int64, device=dev)
    return _slot_uniforms(key, sweep, colors, nij, L, stream, row0)


def sweep_uniforms(key: int, sweep: int, n_colors: int, nij: int, L: int,
                   device=None, row0: int = 0) -> torch.Tensor:
    """All uniforms of one MH sweep: ``[n_colors, nij, L + 1]`` float32.

    ``[..., :L]`` are the jump uniforms of each (color, spaxel row, λ),
    ``[..., L]`` the accept uniform — exactly what the CUDA kernel draws.
    ``row0``: the field's spaxel row of row 0 (a band of the field).
    """
    dev = torch.device(device) if device is not None else None
    jump = _lambda_uniforms(key, sweep, n_colors, nij, L, STREAM_JUMP, dev,
                            row0)
    color = torch.arange(n_colors, dtype=torch.int64, device=dev)[:, None]
    ij = torch.arange(row0, row0 + nij, dtype=torch.int64,
                      device=dev)[None, :]
    acc_bits = philox4x32(
        (0, sweep & M32, color, (STREAM_ACCEPT << 24) | ij), key_words(key)
    )[0]
    acc = bits_to_uniform(torch.broadcast_to(acc_bits, (n_colors, nij)))
    return torch.cat([jump, acc[..., None]], dim=-1)


def gibbs_sweep_uniforms(key: int, sweep: int, n_colors: int, nij: int,
                         L: int, device=None,
                         streams=(STREAM_NORMAL_U1, STREAM_NORMAL_U2),
                         row0: int = 0) -> torch.Tensor:
    """The Box-Muller pairs of one exact-Gibbs sweep: ``[n_colors, nij, 2,
    L]`` float32, ``[:, :, 0]`` = u1 (stream 2), ``[:, :, 1]`` = u2 (stream
    3).  The normal of voxel λ is ``sqrt(−2 log u1) · cos(2π u2)``; u1 is
    never 0, so ``log u1`` is finite."""
    return torch.stack([
        _lambda_uniforms(key, sweep, n_colors, nij, L, stream, device, row0)
        for stream in streams
    ], dim=2)


def block_sweep_uniforms(key: int, sweep: int, n_colors: int, nij: int,
                         L: int, device=None, row0: int = 0) -> torch.Tensor:
    """The Box-Muller pairs of one ``gibbs_block`` sweep, as
    :func:`gibbs_sweep_uniforms` from streams 7 and 8."""
    return gibbs_sweep_uniforms(key, sweep, n_colors, nij, L, device,
                                (STREAM_BLOCK_U1, STREAM_BLOCK_U2), row0)


def pass_slot(entry: int, j: int) -> int:
    """Counter word 2 of a coarse pass's draws: entry << 8 | j."""
    return (entry << 8) | j


def pass_normals(key: int, sweep: int, slots, n_anchor: int, L: int,
                 device=None) -> torch.Tensor:
    """Box-Muller normals of a coarse pass: ``[len(slots), n_anchor, L]``
    float32, sqrt(−2 log u1)·cos(2π u2) with u1, u2 from streams 4, 5."""
    dev = torch.device(device) if device is not None else None
    slots = torch.as_tensor(slots, dtype=torch.int64, device=dev)
    u1, u2 = (_slot_uniforms(key, sweep, slots, n_anchor, L, stream)
              for stream in (STREAM_PASS_U1, STREAM_PASS_U2))
    two_pi = torch.tensor(2.0 * torch.pi, dtype=torch.float32)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)


def cube_normals(key: int, sweep: int, streams, L: int, Y: int, X: int,
                 device=None, dtype=torch.float32,
                 rows=None) -> torch.Tensor:
    """Box-Muller normals of a whole ``[L, Y, X]`` cube, one per voxel:
    sqrt(−2 log u1)·cos(2π u2) with u1, u2 from ``streams`` = (s1, s2),
    word ``λ & 3`` of the block at counter (λ >> 2, sweep, 0, s << 24 |
    y·X + x) — the layout of :func:`_slot_uniforms` with one slot and the
    spaxels as rows (Y·X < 2²⁴).  Each block is computed once for its four
    λs, :data:`NORMALS_CHUNK_L` λs at a time; the normals take ``dtype``.
    ``rows`` = (y0, y1): only the spaxel rows [y0, y1) of the cube,
    ``[L, y1 − y0, X]``, bit-equal to those rows of the whole cube's."""
    if Y * X >= 1 << 24:
        raise ValueError(f"{Y}x{X} spaxels exceed the 24-bit row field")
    y0, y1 = (0, Y) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= y0 <= y1 <= Y:
        raise ValueError(f"rows {rows} outside the cube's 0..{Y}")
    dev = torch.device(device) if device is not None else None
    ij = torch.arange(y0 * X, y1 * X, dtype=torch.int64, device=dev)
    kw = key_words(key)
    out = torch.empty((L, y1 - y0, X), dtype=dtype, device=dev)
    if y1 == y0 or X == 0:
        return out
    two_pi = torch.tensor(2.0 * torch.pi, dtype=torch.float32)
    for lo in range(0, L, NORMALS_CHUNK_L):
        hi = min(L, lo + NORMALS_CHUNK_L)
        q = torch.arange(lo >> 2, (hi + 3) >> 2, dtype=torch.int64,
                         device=dev)[:, None]
        u = []
        for stream in streams:
            words = philox4x32((q, sweep & M32, 0, (stream << 24) | ij), kw)
            # [blocks, 4, Y·X] → λ-major rows 4·block + word
            bits = torch.stack(torch.broadcast_tensors(*words), dim=1)
            u.append(bits_to_uniform(bits.reshape(-1, ij.shape[0]))
                     [lo - 4 * (lo >> 2): hi - 4 * (lo >> 2)])
        z = torch.sqrt(-2.0 * torch.log(u[0])) * torch.cos(two_pi * u[1])
        out[lo:hi] = z.reshape(hi - lo, y1 - y0, X).to(dtype)
    return out


def pass_accept_uniforms(key: int, sweep: int, slots, n_anchor: int,
                         device=None) -> torch.Tensor:
    """The anchor passes' accept uniforms: ``[len(slots), n_anchor]``
    float32, word 0 of the stream-6 block at λ = 0."""
    dev = torch.device(device) if device is not None else None
    slots = torch.as_tensor(slots, dtype=torch.int64, device=dev)
    ij = torch.arange(n_anchor, dtype=torch.int64, device=dev)[None, :]
    bits = philox4x32(
        (0, sweep & M32, slots[:, None], (STREAM_PASS_ACCEPT << 24) | ij),
        key_words(key),
    )[0]
    return bits_to_uniform(torch.broadcast_to(bits, (len(slots), n_anchor)))
