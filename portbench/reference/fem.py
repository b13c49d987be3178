"""Plain reference of the Darcy problem the program solves: P1 finite
elements on the right-diagonal triangulation of the unit square, with a
piecewise-constant conductivity, Dirichlet values on the left and right
edges and zero flux on the top and bottom.

Written from the weak form ``sum_c alpha_c |c| grad(u) . grad(v)``: each
triangle's gradient is taken from its three nodal values and its flux is
scattered back through the gradients of its three basis functions.  The
solve is a plain Jacobi-preconditioned conjugate gradient on the free
nodes.  Plain PyTorch and NumPy; it imports nothing of the program and
takes nothing the program made.

Layouts: images are (B, ny, nx) with row 0 at the top of the domain (the
pixel convention of the program's data); node arrays are (B, ny + 1,
nx + 1) with row 0 at y = 0; square (iy, ix) is split along its
lower-left to upper-right diagonal into the lower triangle (00, 10, 11)
and the upper triangle (00, 11, 01).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


# ----------------------------------------------------------------- geometry
def square_conductivity(log_fields: torch.Tensor) -> torch.Tensor:
    """(B, ny, nx) log-conductivity images -> (B, ny, nx) conductivity per
    grid square, row 0 at y = 0 (both triangles of a square share its
    pixel's value)."""
    return torch.exp(torch.flip(log_fields, dims=(-2,)))


def cell_values(images: np.ndarray) -> np.ndarray:
    """(N, ny, nx) pixel images -> (N, 2 ny nx) values per triangle, cell
    id ``2 (iy nx + ix) + t`` (t = 0 lower, 1 upper)."""
    sq = np.flip(np.asarray(images), axis=-2)  # row 0 at y = 0
    return np.repeat(sq.reshape(sq.shape[0], -1), 2, axis=1)


def _corners(v):
    """The four corner values of every square: v00, v10, v11, v01."""
    return v[:, :-1, :-1], v[:, :-1, 1:], v[:, 1:, 1:], v[:, 1:, :-1]


def stiffness_apply(a_lo: torch.Tensor, a_up: torch.Tensor,
                    v: torch.Tensor, h: tuple) -> torch.Tensor:
    """K(alpha) v: ``a_lo`` / ``a_up`` (B, ny, nx) the conductivity of
    each square's lower / upper triangle, ``v`` (B, ny+1, nx+1) nodal
    values, ``h = (hx, hy)``."""
    hx, hy = h
    area = 0.5 * hx * hy
    v00, v10, v11, v01 = _corners(v)
    # lower triangle: grad v = ((v10 - v00) / hx, (v11 - v10) / hy)
    fx = a_lo * area * (v10 - v00) / hx
    fy = a_lo * area * (v11 - v10) / hy
    out = torch.zeros_like(v)
    out[:, :-1, :-1] -= fx / hx
    out[:, :-1, 1:] += fx / hx - fy / hy
    out[:, 1:, 1:] += fy / hy
    # upper triangle: grad v = ((v11 - v01) / hx, (v01 - v00) / hy)
    fx = a_up * area * (v11 - v01) / hx
    fy = a_up * area * (v01 - v00) / hy
    out[:, :-1, :-1] -= fy / hy
    out[:, 1:, 1:] += fx / hx
    out[:, 1:, :-1] += fy / hy - fx / hx
    return out


def stiffness_diagonal(a_lo, a_up, h) -> torch.Tensor:
    """diag K(alpha) as a node array."""
    hx, hy = h
    area = 0.5 * hx * hy
    B, ny, nx = a_lo.shape
    d = torch.zeros((B, ny + 1, nx + 1), dtype=a_lo.dtype,
                    device=a_lo.device)
    ix2, iy2 = 1.0 / hx ** 2, 1.0 / hy ** 2
    d[:, :-1, :-1] += area * (a_lo * ix2 + a_up * iy2)
    d[:, :-1, 1:] += area * a_lo * (ix2 + iy2)
    d[:, 1:, 1:] += area * (a_lo * iy2 + a_up * ix2)
    d[:, 1:, :-1] += area * a_up * (ix2 + iy2)
    return d


def dirichlet_nodes(theta: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """(B, ny+1, nx+1) node array holding the Dirichlet values of the
    encodings ``theta`` (B, 4) = (u0, u1, u2, u3) on the left (u0 (1-y) +
    u1 y) and right (u2 (1-y) + u3 y) edges, zero elsewhere."""
    y = torch.linspace(0.0, 1.0, ny + 1, dtype=theta.dtype,
                       device=theta.device)
    u = torch.zeros((theta.shape[0], ny + 1, nx + 1), dtype=theta.dtype,
                    device=theta.device)
    u[:, :, 0] = theta[:, :1] * (1 - y) + theta[:, 1:2] * y
    u[:, :, nx] = theta[:, 2:3] * (1 - y) + theta[:, 3:4] * y
    return u


def free_mask(ny: int, nx: int, dtype, device) -> torch.Tensor:
    m = torch.ones((1, ny + 1, nx + 1), dtype=dtype, device=device)
    m[:, :, 0] = 0
    m[:, :, nx] = 0
    return m


def solve(log_fields: torch.Tensor, theta: torch.Tensor, *, tol: float,
          maxiter: int = 20000):
    """Nodal solutions (B, ny+1, nx+1) of the Darcy problems of the
    log-conductivity images ``log_fields`` (B, ny, nx) under the Dirichlet
    encodings ``theta`` (B, 4), in the inputs' dtype: Jacobi-PCG on the
    free nodes, each system iterated until its residual is ``tol`` times
    its right-hand side.  Returns (u, iterations)."""
    B, ny, nx = log_fields.shape
    h = (1.0 / nx, 1.0 / ny)
    a = square_conductivity(log_fields)
    m = free_mask(ny, nx, a.dtype, a.device)
    uD = dirichlet_nodes(theta.to(a.dtype), ny, nx)
    b = -m * stiffness_apply(a, a, uD, h)
    dinv = m / stiffness_diagonal(a, a, h)

    def dot(p, q):
        return (p * q).sum(dim=(1, 2))

    x = torch.zeros_like(b)
    r = b.clone()
    z = dinv * r
    p = z.clone()
    rz = dot(r, z)
    target = tol ** 2 * dot(b, b)
    k = 0
    while k < maxiter:
        active = dot(r, r) > target
        if not bool(active.any()):
            break
        Ap = m * stiffness_apply(a, a, p, h)
        pAp = dot(p, Ap)
        step = torch.where(active & (pAp != 0), rz / torch.where(
            pAp == 0, torch.ones_like(pAp), pAp), torch.zeros_like(pAp))
        x = x + step[:, None, None] * p
        r = r - step[:, None, None] * Ap
        z = dinv * r
        rz_new = dot(r, z)
        beta = torch.where(rz == 0, torch.zeros_like(rz),
                           rz_new / torch.where(rz == 0, torch.ones_like(rz),
                                                rz))
        p = z + beta[:, None, None] * p
        rz = rz_new
        k += 1
    return uD + x, k


def free_values(u: torch.Tensor) -> torch.Tensor:
    """Nodal arrays (B, ny+1, nx+1) -> (B, n_free), the interior columns
    of every row in node-id order (node id ``iy (nx+1) + ix``)."""
    return u[:, :, 1:-1].reshape(u.shape[0], -1)


def centre_value(u: torch.Tensor) -> torch.Tensor:
    """(B,) the solution at the domain's centre, a node of an even grid."""
    ny, nx = u.shape[1] - 1, u.shape[2] - 1
    if nx % 2 or ny % 2:
        raise ValueError("the centre is a node only on even grids")
    return u[:, ny // 2, nx // 2]


def moments(q: np.ndarray, cases: int) -> dict:
    """Per-case mean, std (ddof 0) and 5th / 95th percentiles (linear
    interpolation) of case-major values, float64."""
    q = np.asarray(q, dtype=np.float64).reshape(cases, -1)
    return {"mean": q.mean(axis=1), "std": q.std(axis=1),
            "p5": np.percentile(q, 5, axis=1),
            "p95": np.percentile(q, 95, axis=1)}


# ------------------------------------------------------ boundary encodings
def ndp_thetas(fields: np.ndarray) -> np.ndarray:
    """The 'NDP' encodings the labelled data carries: (N, 4) uniform on
    [-1/2, 1/2), drawn from a NumPy generator seeded by the first 16 hex
    digits of the SHA-256 of the float64 field array."""
    digest = hashlib.sha256(np.ascontiguousarray(
        np.asarray(fields, dtype=np.float64))).hexdigest()
    rng = np.random.default_rng(int(digest[:16], 16))
    return rng.uniform(-0.5, 0.5, size=(np.asarray(fields).shape[0], 4))


def rom_force(theta: np.ndarray, n: int) -> np.ndarray:
    """(N, (n+1)^2) zero force with the Dirichlet values of ``theta`` at
    the left and right edge nodes of an n x n grid, node-id order."""
    th = torch.as_tensor(np.asarray(theta, dtype=np.float64))
    return dirichlet_nodes(th, n, n).reshape(th.shape[0], -1).numpy()


# ------------------------------------------------------------- coarse model
def _local_gradients(h):
    """(2, 3, 2) basis gradients of the lower (00, 10, 11) and upper
    (00, 11, 01) triangle."""
    hx, hy = h
    lower = [(-1 / hx, 0.0), (1 / hx, -1 / hy), (0.0, 1 / hy)]
    upper = [(0.0, -1 / hy), (1 / hx, 0.0), (-1 / hx, 1 / hy)]
    return np.array([lower, upper])


def assembly_tensor(n: int) -> np.ndarray:
    """(d, d, c) with K(alpha) = M . alpha on an n x n grid: d nodes, c
    cells (cell id ``2 (iy n + ix) + t``)."""
    h = (1.0 / n, 1.0 / n)
    area = 0.5 * h[0] * h[1]
    G = _local_gradients(h)
    d = (n + 1) ** 2
    M = np.zeros((d, d, 2 * n * n))
    for iy in range(n):
        for ix in range(n):
            n00, n10 = iy * (n + 1) + ix, iy * (n + 1) + ix + 1
            n11, n01 = n10 + n + 1, n00 + n + 1
            for t, nodes in enumerate(((n00, n10, n11), (n00, n11, n01))):
                c = 2 * (iy * n + ix) + t
                K = area * G[t] @ G[t].T
                for i in range(3):
                    for j in range(3):
                        M[nodes[i], nodes[j], c] += K[i, j]
    return M


def interpolation_matrix(coarse: int, fine: int) -> np.ndarray:
    """(n_free_fine, (coarse+1)^2): the coarse grid's P1 interpolant at
    the fine grid's free nodes (interior columns, node-id order)."""
    xs = np.arange(fine + 1) / fine
    X, Y = np.meshgrid(xs[1:-1], xs, indexing="xy")
    px, py = X.ravel() * coarse, Y.ravel() * coarse
    ix = np.minimum(np.floor(px).astype(int), coarse - 1)
    iy = np.minimum(np.floor(py).astype(int), coarse - 1)
    fx, fy = px - ix, py - iy
    W = np.zeros((px.size, (coarse + 1) ** 2))
    rows = np.arange(px.size)
    n00 = iy * (coarse + 1) + ix
    n10, n01 = n00 + 1, n00 + coarse + 1
    n11 = n01 + 1
    lower = fx >= fy
    for node, w in ((n00, np.where(lower, 1 - fx, 1 - fy)),
                    (n10, np.where(lower, fx - fy, 0.0)),
                    (n11, np.where(lower, fy, fx)),
                    (n01, np.where(lower, 0.0, fy - fx))):
        np.add.at(W, (rows, node), w)
    return W


def rom_solve(M: torch.Tensor, alpha: torch.Tensor, F: torch.Tensor,
              n: int) -> torch.Tensor:
    """Coarse solutions (..., d): K(alpha) y = 0 on the free nodes, y = F
    on the left and right edge nodes, by a dense LU solve."""
    d = (n + 1) ** 2
    node = np.arange(d)
    edge = (node % (n + 1) == 0) | (node % (n + 1) == n)
    fr = torch.as_tensor(np.flatnonzero(~edge), device=F.device)
    bc = torch.as_tensor(np.flatnonzero(edge), device=F.device)
    K = torch.einsum("ijc,...c->...ij", M, alpha)
    Kff = K[..., fr[:, None], fr[None, :]]
    Kfc = K[..., fr[:, None], bc[None, :]]
    rhs = -torch.einsum("...ij,...j->...i", Kfc, F[..., bc])
    y = F.clone()
    y[..., fr] = torch.linalg.solve(Kff, rhs[..., None])[..., 0]
    return y
