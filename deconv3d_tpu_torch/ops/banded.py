"""Banded SPD linear algebra: spectral precisions, Cholesky, conditional draws.

Counterpart of ``deconv3d_tpu/ops/banded.py``.  The conditional precision
of a spectrum under the separable model is A = Mᵀ diag(q) M, with M the
banded LSF matrix (``M[μ, μ + d − half] = lsf[μ, d]``) and q per-λ
quadratic weights (``sampler.Problem.quad`` for one voxel, a coarse
pattern's response norm for the global pass of ``ops/coarse.py``).  A is
banded with bandwidth p = lw − 1, so a draw x ~ N(A⁻¹b, A⁻¹) costs O(L·lw²)
through a banded Cholesky A = RᵀR and two triangular solves.

Band storage: ``bands[..., l, k]`` holds A[l, l+k] for k = 0..p (zero past
the matrix edge).  Every routine is batched over leading dims.  The
``*_reference`` functions and the solves are plain torch loops over λ
(the JAX package's ``lax.scan``s); :func:`cholesky_banded`,
:func:`sample_conditional` and :func:`banded_solve` (x = A⁻¹b for
λ-major columns that share factors: the direct sampler's
preconditioner) run them on CPU tensors and, on CUDA tensors, the
kernels of ``csrc/banded.cu``, which a failed build or launch does not
turn into the plain loop: it raises.  The Cholesky kernel runs each
system's rows on a group of lanes, one lane per band entry, right-looking
(:func:`rightlooking_cholesky_reference` is its order of operations in
plain torch, for the tests); the draw and the solve cut each system's or
column's rows into segments solved side by side and joined by a carry of
the p-vector state (:func:`segments`, :func:`solve_split`;
:func:`segmented_solve_reference` is their arithmetic in plain torch, for
the tests).
"""

from __future__ import annotations

import math

import torch

#: largest bandwidth the kernels take (lw ≤ 11)
MAX_P = 10

#: the smallest squared pivot of the Cholesky (zero rows stay finite)
EPS = 1e-30


def precision_diag(lsf: torch.Tensor, q_lfirst: torch.Tensor) -> torch.Tensor:
    """diag(Mᵀ diag(q) M) for λ-leading ``q_lfirst`` ``[L, ...spatial]``:
    ``out[λ] = Σ_d lsf[λ + half − d, d]² · q[λ + half − d]`` (zero outside)."""
    L, lw = lsf.shape
    half = lw // 2
    pads = (0, 0) * (q_lfirst.ndim - 1) + (lw, lw)
    qp = torch.nn.functional.pad(q_lfirst, pads)
    lsfp = torch.nn.functional.pad(lsf, (0, 0, lw, lw))
    out = torch.zeros_like(q_lfirst)
    shape = (L,) + (1,) * (q_lfirst.ndim - 1)
    for d in range(lw):
        off = lw + half - d
        col = (lsfp[off : off + L, d] ** 2).reshape(shape)
        out = out + col * qp[off : off + L]
    return out


def precision_bands(lsf: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Bands of A = Mᵀ diag(q) M: ``[..., L, lw]`` for ``q`` ``[..., L]``,
    ``bands[..., l, k] = Σ_d q[l+half−d]·lsf[l+half−d, d]·lsf[l+half−d,
    d+k]``."""
    L, lw = lsf.shape
    half = lw // 2
    qp = torch.nn.functional.pad(q, (lw, lw))
    lsfp = torch.nn.functional.pad(lsf, (0, 0, lw, lw))
    edge = torch.arange(L, device=q.device)
    out = []
    for k in range(lw):
        acc = torch.zeros_like(q)
        for d in range(lw - k):
            # μ = l + half − d for l = 0..L-1 → padded index l + lw + half − d
            off = lw + half - d
            acc = acc + (qp[..., off : off + L] * lsfp[off : off + L, d]
                         * lsfp[off : off + L, d + k])
        # zero the entries whose column l + k falls off the matrix edge
        out.append(torch.where(edge < L - k, acc, torch.zeros_like(acc)))
    return torch.stack(out, dim=-1)


def cholesky_banded_reference(bands: torch.Tensor,
                              jitter: float = 0.0) -> torch.Tensor:
    """Upper banded Cholesky A = RᵀR, plain torch, one step per row.

    ``bands`` ``[..., L, p+1]``; returns R in the same layout (R[l, l+k] at
    ``[..., l, k]``).  ``jitter`` scales the pivot by (1 + jitter); a pivot
    below :data:`EPS` (a fully masked row) becomes sqrt(EPS), so the solves
    stay finite.
    """
    L, W = bands.shape[-2:]
    p = W - 1
    batch = bands.shape[:-2]
    dev = bands.device
    m = torch.arange(p, device=dev)[:, None]
    k = torch.arange(W, device=dev)[None, :]
    # G[m, k] = prev[m][m + 1 + k] = R[l-1-m, l+k]; prev[m] = row l-1-m
    idx = (m + 1 + k).clamp(max=p).expand(*batch, p, W)
    keep = (m + 1 + k <= p).to(bands.dtype)
    prev = bands.new_zeros((*batch, p, W))
    out = torch.empty_like(bands)
    for l in range(L):
        G = torch.gather(prev, -1, idx) * keep
        s = bands[..., l, :] - (G[..., :1] * G).sum(dim=-2)
        rii = torch.sqrt(torch.clamp(s[..., :1] * (1.0 + jitter), min=EPS))
        row = torch.cat([rii, s[..., 1:] / rii], dim=-1)
        out[..., l, :] = row
        if p:
            prev = torch.cat([row[..., None, :], prev[..., :-1, :]], dim=-2)
    return out


def rightlooking_cholesky_reference(bands: torch.Tensor,
                                    jitter: float = 0.0) -> torch.Tensor:
    """The Cholesky kernel's order of operations in plain torch (tests
    only): :func:`cholesky_banded_reference`'s factor, right-looking.  Row
    l, once known, subtracts R[l, l+i]·R[l, l+i+k] from entry k of row l +
    i (i = 1..p, i + k ≤ p), so each entry takes its updates in row order
    and the row's own pivot is x = max(s₀·(1 + jitter), EPS): R[l, l] =
    x·rsqrt(x), R[l, l+k] = s_k·rsqrt(x) (``csrc/banded.cu``
    ``banded_cholesky_kernel``, which fuses each update into an fma and
    takes the hardware's approximate rsqrt)."""
    L, W = bands.shape[-2:]
    p = W - 1
    dev = bands.device
    i = torch.arange(1, p + 1, device=dev)[:, None]
    k = torch.arange(W, device=dev)[None, :]
    # U[i-1, k] = r[i]·r[i+k] for i + k <= p
    idx = (i + k).clamp(max=p).expand(*bands.shape[:-2], p, W)
    keep = (i + k <= p).to(bands.dtype)
    pend = bands.clone()
    out = torch.empty_like(bands)
    for l in range(L):
        s = pend[..., l, :]
        x = torch.clamp(s[..., :1] * (1.0 + jitter), min=EPS)
        inv = torch.rsqrt(x)
        row = torch.cat([x * inv, s[..., 1:] * inv], dim=-1)
        out[..., l, :] = row
        n = min(p, L - 1 - l)
        if n:
            U = row[..., 1:, None] * torch.gather(
                row[..., None, :].expand(*row.shape[:-1], p, W), -1, idx)
            pend[..., l + 1:l + 1 + n, :] -= (U * keep)[..., :n, :]
    return out


def solve_transposed_banded(R: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve Rᵀ z = b (forward substitution; Rᵀ is lower-banded), plain
    torch: ``acc[k]`` carries Σ_i R[i, l+1+k]·z[i] over the rows done."""
    L, W = R.shape[-2:]
    p = W - 1
    acc = b.new_zeros((*b.shape[:-1], p))
    z = torch.empty_like(b)
    for l in range(L):
        if not p:
            z[..., l] = b[..., l] / R[..., l, 0]
            continue
        zl = (b[..., l] - acc[..., 0]) / R[..., l, 0]
        acc = (torch.nn.functional.pad(acc[..., 1:], (0, 1))
               + R[..., l, 1:] * zl[..., None])
        z[..., l] = zl
    return z


def solve_banded(R: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve R x = b (backward substitution; R is upper-banded), plain
    torch: ``hist[m]`` = x[l+1+m]."""
    L, W = R.shape[-2:]
    p = W - 1
    hist = b.new_zeros((*b.shape[:-1], p))
    x = torch.empty_like(b)
    for l in range(L - 1, -1, -1):
        xl = (b[..., l] - (R[..., l, 1:] * hist).sum(dim=-1)) / R[..., l, 0]
        if p:
            hist = torch.cat([xl[..., None], hist[..., :-1]], dim=-1)
        x[..., l] = xl
    return x


def sample_conditional_reference(R: torch.Tensor, b: torch.Tensor,
                                 noise: torch.Tensor) -> torch.Tensor:
    """x ~ N(A⁻¹b, A⁻¹) for A = RᵀR and standard-normal ``noise``, plain
    torch.  Mean: Rᵀz = b, Rμ = z; fluctuation: Rη = noise, cov(η) = A⁻¹."""
    return solve_banded(R, solve_transposed_banded(R, b) + noise)


def solve_banded_reference(R: torch.Tensor, fidx: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """x = R⁻¹ R⁻ᵀ b for the λ-major columns of ``b`` ``[L, n]``, column j
    against the factor ``R[fidx[j]]`` of ``R`` ``[n_factors, L, p+1]``:
    the solves of the direct sampler's preconditioner
    (``solve_banded(R, solve_transposed_banded(R, b))`` on ``R[fidx]``),
    plain torch.  Each step gathers its factor rows, so no per-column copy
    of the factors is made."""
    L, W = R.shape[-2:]
    p = W - 1
    fidx = fidx.to(device=R.device, dtype=torch.int64)
    n = b.shape[1]
    acc = b.new_zeros((n, p))
    z = torch.empty_like(b)
    for l in range(L):
        Rl = R[:, l][fidx]                               # [n, W]
        zl = (b[l] - (acc[:, 0] if p else 0.0)) / Rl[:, 0]
        if p:
            acc = (torch.nn.functional.pad(acc[:, 1:], (0, 1))
                   + Rl[:, 1:] * zl[:, None])
        z[l] = zl
    hist = b.new_zeros((n, p))
    x = torch.empty_like(b)
    for l in range(L - 1, -1, -1):
        Rl = R[:, l][fidx]
        xl = (z[l] - (Rl[:, 1:] * hist).sum(dim=-1)) / Rl[:, 0]
        if p:
            hist = torch.cat([xl[:, None], hist[:, :-1]], dim=-1)
        x[l] = xl
    return x


#: threads that fill an H100 (132 SMs): the batch limit of the split rule
FILL_LANES = 32768

#: a segmented solve's block: 8 warps; fewer blocks than SOLVE_BLOCKS
#: split the columns finer
SOLVE_WARPS, SOLVE_BLOCKS = 8, 64


def solve_split(n: int, L: int, p: int) -> tuple[int, int]:
    """(columns per block C, segments per column S) of the solve kernel
    for ``n`` columns of ``L`` rows and bandwidth ``p``
    (``csrc/banded.cu``'s ``solve_split``): S = 1 (32 columns a warp) for
    :data:`FILL_LANES` columns or more; else a block of 8 warps holds C
    columns of S = 8·32/C segments, C halving from 32 while the blocks are
    fewer than :data:`SOLVE_BLOCKS` and doubling back while a segment
    would get fewer than max(p, 4) rows."""
    C, min_rows = 32, max(p, 4)
    if n >= FILL_LANES:
        return C, 1
    while C > 1 and -(-n // C) < SOLVE_BLOCKS:
        C //= 2
    while C < 32 and SOLVE_WARPS * (32 // C) * min_rows > L:
        C *= 2
    return C, SOLVE_WARPS * (32 // C)


def segments(n: int, L: int, p: int, kind: str = "sample") -> int:
    """Segments per system (``kind`` 'sample') or column ('solve') that
    the kernels cut ``n`` systems or columns of ``L`` rows and bandwidth
    ``p`` into, one thread each (``csrc/banded.cu``'s ``segments`` and
    ``solve_split``, which the card's test holds this against).  The
    draw: S doubles from 1 while S < 32 (a warp), n·S <
    :data:`FILL_LANES` and every segment keeps max(p, 4) rows or more."""
    if kind == "solve":
        return solve_split(n, L, p)[1]
    S, min_rows = 1, max(p, 4)
    while S < 32 and n * S < FILL_LANES and 2 * S * min_rows <= L:
        S *= 2
    return S


def segment_rows(L: int, S: int) -> int:
    """Rows per segment of the kernels' split: ceil(L / S), made odd
    (``csrc/banded.cu``'s ``segment_rows``: the draw's lanes, m·(p+1)
    floats apart, then read distinct shared-memory banks for even p)."""
    return -(-L // S) | 1


def segmented_solve_reference(R: torch.Tensor, fidx: torch.Tensor,
                              b: torch.Tensor, m: int,
                              noise: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """The kernels' segmented arithmetic in plain torch (tests only): x =
    R⁻¹(R⁻ᵀb + noise) for the λ-major columns of ``b`` ``[L, n]``, column
    j against ``R[fidx[j]]`` (``noise`` ``[L, n]`` or None: the solve).

    Each column's rows are cut into segments of ``m`` (the last one
    shorter).  Each solve runs every segment from a zero state together
    with its response to the p unit states (the state leaving it is part
    + T·in), carries the state over the segments in order (forward:
    first to last; backward: last to first) and runs every segment again
    from its true incoming state; a row multiplies by the reciprocal of
    its pivot (rounded once here; the kernels take the hardware's
    approximate one).  The carried states: forward ``acc[k]`` = Σ over the rows
    i done of R[i, l+k]·z[i], backward the last p solution values."""
    L, W = R.shape[-2:]
    p = W - 1
    n = b.shape[1]
    S = -(-L // m)
    pad = S * m - L
    Rc = R[fidx.to(device=R.device, dtype=torch.int64)]
    unit = R.new_zeros(W)
    unit[0] = 1.0
    Rc = torch.cat([Rc, unit.expand(n, pad, W)], 1).reshape(n, S, m, W)
    inv = 1.0 / Rc[..., 0]
    valid = (torch.arange(S * m, device=R.device) < L).reshape(S, m)

    def seg(v):
        return torch.cat([v.T, v.new_zeros(n, pad)], 1).reshape(n, S, m)

    def step(st, v, i, forward):
        """One row i of every segment for states ``st`` [..., k, p] with
        right-hand sides ``v`` [..., k]."""
        row, keep = Rc[:, :, i], valid[None, :, i, None]
        if forward:
            z = (v - st[..., 0]) * inv[:, :, i, None]
            new = (torch.nn.functional.pad(st[..., 1:], (0, 1))
                   + row[:, :, None, 1:] * z[..., None])
        else:
            z = (v - (row[:, :, None, 1:] * st).sum(-1)) * inv[:, :, i, None]
            new = torch.cat([z[..., None], st[..., :-1]], -1)
        return torch.where(keep[..., None], new, st), z

    def solve(v, forward):
        rows = range(m) if forward else range(m - 1, -1, -1)
        if p == 0:
            return v * inv
        inn = v.new_zeros(n, S, 1, p)
        if S > 1:
            # part (unit 0) and T (units 1..p): states out of each segment
            st = torch.eye(p, dtype=v.dtype, device=v.device)
            st = torch.cat([st.new_zeros(1, p), st]).expand(n, S, p + 1, p)
            coef = torch.zeros(p + 1, dtype=v.dtype, device=v.device)
            coef[0] = 1.0
            for i in rows:
                st, _ = step(st, v[:, :, i, None] * coef, i, forward)
            part, T = st[:, :, 0], st[:, :, 1:].transpose(-1, -2)
            order = (range(1, S) if forward else range(S - 2, -1, -1))
            for s in order:
                src = s - 1 if forward else s + 1
                inn[:, s, 0] = part[:, src] + (T[:, src]
                                               @ inn[:, src, 0, :, None])[..., 0]
        out = torch.empty_like(v)
        st = inn
        for i in rows:
            st, z = step(st, v[:, :, i, None], i, forward)
            out[:, :, i] = z[..., 0]
        return out

    y = solve(seg(b), True)
    if noise is not None:
        y = y + seg(noise)
    x = solve(y, False)
    return x.reshape(n, S * m)[:, :L].T.contiguous()


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

def _kernel_input(name: str, t: torch.Tensor, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}: the banded kernels take "
                         "CUDA tensors (the plain loops CPU tensors)")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernels take "
                        "torch.float32")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _bandwidth(bands: torch.Tensor) -> int:
    p = bands.shape[-1] - 1
    if not 0 <= p <= MAX_P:
        raise ValueError(f"bandwidth {p} is outside the kernels' 0..{MAX_P}")
    return p


def _launch(name: str, *args) -> None:
    import ctypes

    from .. import _build

    fn = getattr(_build.load_library(), name)
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    conv = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
            else a for a in args]
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = fn(*conv, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def cholesky_banded(bands: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Upper banded Cholesky of ``bands`` ``[..., L, p+1]``
    (:func:`cholesky_banded_reference`): on a CUDA tensor one launch of
    ``banded_cholesky_kernel`` (``csrc/banded.cu``: a group of p + 1 lanes
    or more per system, :func:`rightlooking_cholesky_reference`'s order)
    for every system of the batch, counted by ``cholesky_banded.launches``;
    on a CPU tensor the plain loop."""
    if bands.device.type == "cpu":
        return cholesky_banded_reference(bands, jitter)
    p = _bandwidth(bands)
    _kernel_input("bands", bands, bands.shape)
    L = bands.shape[-2]
    out = torch.empty_like(bands)
    _launch("banded_cholesky_launch", bands, out,
            math.prod(bands.shape[:-2]), L, p, float(jitter))
    cholesky_banded.launches += 1
    return out


cholesky_banded.launches = 0


def sample_conditional(R: torch.Tensor, b: torch.Tensor,
                       noise: torch.Tensor) -> torch.Tensor:
    """x ~ N(A⁻¹b, A⁻¹) for A = RᵀR (:func:`sample_conditional_reference`):
    on CUDA tensors one launch of ``banded_sample_kernel``
    (``csrc/banded.cu``: both solves, :func:`segments` per system) for
    every system of the batch,
    counted by ``sample_conditional.launches``; on CPU tensors the plain
    loops."""
    if R.device.type == "cpu" and b.device.type == "cpu" \
            and noise.device.type == "cpu":
        return sample_conditional_reference(R, b, noise)
    p = _bandwidth(R)
    _kernel_input("R", R, R.shape)
    _kernel_input("b", b, R.shape[:-1])
    _kernel_input("noise", noise, R.shape[:-1])
    if not (R.device == b.device == noise.device):
        raise ValueError("R, b and noise must lie on one CUDA device")
    out = torch.empty_like(b)
    _launch("banded_sample_launch", R, b, noise, out,
            math.prod(R.shape[:-2]), R.shape[-2], p)
    sample_conditional.launches += 1
    return out


sample_conditional.launches = 0


def banded_solve(R: torch.Tensor, fidx: torch.Tensor, b: torch.Tensor,
                 out=None) -> torch.Tensor:
    """x = R⁻¹ R⁻ᵀ b for λ-major columns ``b`` ``[L, n]`` against shared
    factors (:func:`solve_banded_reference`): on CUDA tensors one launch of
    ``banded_solve_kernel`` (``csrc/banded.cu``, :func:`solve_split`),
    counted by ``banded_solve.launches``, into ``out`` (default a new
    tensor; ``b`` itself solves in place); on CPU tensors the plain loops.
    ``fidx`` is int32 on the kernel's path."""
    if R.device.type == "cpu" and b.device.type == "cpu":
        x = solve_banded_reference(R, fidx, b)
        if out is None:
            return x
        return out.copy_(x)
    p = _bandwidth(R)
    L, n = b.shape
    _kernel_input("R", R, R.shape)
    _kernel_input("b", b, (R.shape[-2], n))
    if out is None:
        out = torch.empty_like(b)
    _kernel_input("out", out, b.shape)
    if fidx.device != R.device or fidx.dtype != torch.int32 \
            or tuple(fidx.shape) != (n,):
        raise ValueError(f"fidx must be int32 [{n}] on {R.device}, got "
                         f"{fidx.dtype} {tuple(fidx.shape)} on {fidx.device}")
    if not (R.device == b.device == out.device):
        raise ValueError("R, b and out must lie on one CUDA device")
    _launch("banded_solve_launch", R, fidx.contiguous(), b, out, n, L, p)
    banded_solve.launches += 1
    return out


banded_solve.launches = 0
