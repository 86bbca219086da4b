"""A zoo of user-written vector fields ``f(u, p, t)`` in torch (batched
rows, as the plain solve calls them), written the way a user writes them:
the ops the batched RK kernel's tracer lowers beyond elementwise arithmetic
(selects, functions, rolls, reductions, matrix products, writes through
views), and fields whose interval maps pass the two-phase backward. tests/test_torch_rhs_wide.py
holds them against JAX's Pallas solve on the CPU, tests/test_torch_cuda.py
the kernels on them against their plain versions on the card.
"""
import numpy as np
import torch
import torch.nn.functional as F


def lorenz96(u, p, t):
    """Lorenz-96 with the forcing F = p[0], written with torch.roll."""
    return ((torch.roll(u, -1, -1) - torch.roll(u, 2, -1))
            * torch.roll(u, 1, -1) - u + p[..., 0:1])


def hill(u, p, t):
    """A three-gene repressilator: each gene repressed through a sigmoid of
    the one before it, p = (rate, steepness, decay)."""
    a, n, g = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    return a * torch.sigmoid(-n * torch.roll(u, 1, -1)) - g * u


def lv_softplus(u, p, t):
    """Lotka-Volterra whose growth and death rates pass a softplus."""
    x, y = u[..., 0], u[..., 1]
    a, b, c, d = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return torch.stack([F.softplus(a) * x - b * x * y,
                        d * x * y - F.softplus(c, beta=2.0) * y], -1)


def clamp_friction(u, p, t):
    """An oscillator with saturating friction, a one-sided spring (relu)
    and a maximum."""
    x, v = u[..., 0], u[..., 1]
    k, mu = p[..., 0], p[..., 1]
    return torch.stack([v, -k * x - mu * torch.clamp(v * 10.0, -1.0, 1.0)
                        + torch.relu(-x) - torch.maximum(x, v) * 0.1], -1)


def kuramoto_mean(u, p, t):
    """Mean-field Kuramoto: omega + K mean_j sin(phi_j - phi_i)."""
    s = torch.sin(u[..., None, :] - u[..., :, None])
    return p[..., 0:1] + p[..., 1:2] * s.mean(-1)


def linear5(u, p, t):
    """A linear field whose matrix is the parameters, p.reshape(d, d) @ u,
    with a damping by the state's 2-norm."""
    A = p.reshape(*p.shape[:-1], 5, 5)
    return ((A @ u[..., None])[..., 0]
            - 0.01 * torch.linalg.vector_norm(u, dim=-1, keepdim=True) * u)


def mlp(u, p, t):
    """A one-hidden-layer tanh field, dim 4, hidden 8, its 76 weights the
    parameters."""
    W1 = p[..., :32].reshape(*p.shape[:-1], 8, 4)
    W2 = p[..., 40:72].reshape(*p.shape[:-1], 4, 8)
    h = torch.tanh(torch.einsum("...ij,...j->...i", W1, u) + p[..., 32:40])
    return torch.einsum("...ij,...j->...i", W2, h) + p[..., 72:76]


def selects(u, p, t):
    """The index rearrangements, extrema, short reductions and scans and the
    tensor-bound clamps, each in a form whose plain versions fix its order
    (extrema of any length, sums and products of two terms)."""
    lo = torch.clamp_min(u * 0.5, -0.25)
    spread = torch.amax(u, -1, keepdim=True) - torch.amin(u, -1, keepdim=True)
    head = torch.cumsum(u[..., :2], -1)
    return (0.5 * torch.flip(u, [-1]) * p[..., 0:1] - 2.0 * u - 0.1 * spread
            + 0.1 * torch.prod(torch.tanh(u[..., :2]), -1, keepdim=True)
            + 0.1 * torch.cat([head, head], -1)
            + torch.clamp(u, min=-p[..., 1:2], max=p[..., 1:2])
            + 0.1 * torch.minimum(u, lo)
            + 0.1 * u[..., :2].mean(-1, keepdim=True))


def gelu_field(u, p, t):
    return (F.gelu(u) * p[..., 0:1] - torch.erf(u) * p[..., 1:2]
            + F.gelu(u, approximate="tanh") - 4.0 * u)


def atan_field(u, p, t):
    """A polar drift: atan2, expm1, log1p, sinh and cosh."""
    x, y = u[..., 0], u[..., 1]
    return torch.stack([torch.atan2(y, x) * p[..., 0] - torch.expm1(x * 0.1),
                        torch.log1p(x * x) - torch.sinh(y)
                        + torch.cosh(x) * 0.01], -1)


def inplace(u, p, t):
    """A damped chain written with in-place updates through views: each
    element driven by the one before it, the first doubled, and a view
    taken before that write read after it."""
    du = -p[..., 0:1] * u
    du[..., 1:].add_(u[..., :-1])
    head = du[..., :2]
    du[..., 0].mul_(2.0)
    return du + 0.1 * head.sum(-1, keepdim=True)


# name -> (field, dim, pdim, the route of its backward)
ZOO = {
    "lorenz96-12": (lorenz96, 12, 1, "sweep"),
    "hill": (hill, 3, 3, "maps"),
    "lv-softplus": (lv_softplus, 2, 4, "maps"),
    "clamp-friction": (clamp_friction, 2, 2, "maps"),
    "kuramoto-mean": (kuramoto_mean, 6, 2, "maps"),
    "linear5": (linear5, 5, 25, "sweep"),
    "mlp": (mlp, 4, 76, "sweep"),
    "selects": (selects, 4, 2, "maps"),
    "gelu": (gelu_field, 3, 2, "maps"),
    "atan": (atan_field, 2, 1, "maps"),
    "inplace": (inplace, 4, 1, "maps"),
}


def draws(name, R, seed):
    """Rows the fields meet on a solve, as float32 numpy arrays: states ~
    U(-1, 1) (the polar field's x ~ U(0, 2), off atan2's branch cut; the
    populations ~ U(0, 2);
    Lorenz-96 ~ U(-2, 2) with F ~ U(4, 8); phases ~ U(-pi, pi)),
    parameters ~ U(0.5, 2) (the weight fields' ~ U(-0.5, 0.5))."""
    rng = np.random.default_rng(seed)
    _, dim, pdim, _ = ZOO[name]
    u = rng.uniform(-1.0, 1.0, (R, dim))
    p = rng.uniform(0.5, 2.0, (R, pdim))
    if name in ("atan", "lv-softplus"):  # x > 0; positive populations
        u[:, 0] += 1.0
        if name == "lv-softplus":
            u[:, 1] += 1.0
    elif name == "lorenz96-12":
        u, p = 2.0 * u, 4.0 + 4.0 * rng.uniform(0.0, 1.0, (R, pdim))
    elif name == "kuramoto-mean":
        u = u * np.pi
    elif name in ("linear5", "mlp"):
        p = rng.uniform(-0.5, 0.5, (R, pdim))
    return u.astype(np.float32), p.astype(np.float32)
