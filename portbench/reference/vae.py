"""Plain reference of one SVI step of the semi-supervised physics-informed
VAE of BASELINE config 3: the composite ELBO (an amortized unlabeled term
and a labeled term with Monte-Carlo samples), its gradient and Adam.

Written from the model's description with plain ``torch`` operations:
a DenseNet-style convolutional decoder (dense layer -> latent image ->
3x3 conv -> dense blocks and x2 nearest up-transitions -> the last
decoding to a mean and a log-sigma image), a convolutional encoder
(7x7 stride-2 conv -> dense blocks and stride-2 down-transitions -> a
dense layer -> two linear heads), BatchNorm with batch statistics and
epsilon 1e-5, "same" padding, a linear map from the latent to the coarse
log-conductivity, the coarse finite-element solve of ``reference.fem`` and
its interpolation to the fine free nodes.  The unlabeled term's convolutions
run in the configuration's reduced precision (BatchNorm statistics in
float32), everything else in float32.  It imports nothing of the program:
its parameters are named as the configuration's checkpoints name them, so
that the benchmark can hand the same seeded weights to both sides.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import fem

LOG_2PI = math.log(2 * math.pi)


# ------------------------------------------------------------- parameters
def _codec_spec(m: dict):
    """(name, shape) of every parameter of the decoder ``f`` and the
    encoder, in the configuration's naming."""
    out = []

    def conv(name, cin, cout, k):
        out.append((f"{name}.weight", (cout, cin, k, k)))

    def bn(name, c):
        out.append((f"{name}.weight", (c,)))
        out.append((f"{name}.bias", (c,)))

    def dense(name, cin, cout):
        out.append((f"{name}.weight", (cout, cin)))
        out.append((f"{name}.bias", (cout,)))

    d, e, zd = m["decoder"], m["encoder"], m["dim_latent"]
    s, c0 = d["latent_img_size"], d["latent_img_features"]
    dense("f.Dense_0", zd, s * s * c0)
    conv("f.Conv_0", c0, d["init_features"], 3)
    nf, g = d["init_features"], d["growth_rate"]
    for i, nl in enumerate(d["blocks"]):
        for j in range(nl):
            p = f"f.DenseBlock_{i}.DenseLayer_{j}.NormReluConv_0"
            bn(p + ".BatchNorm_0", nf + j * g)
            conv(p + ".Conv_0", nf + j * g, g, 3)
        nf += nl * g
        if i < len(d["blocks"]) - 1:
            p = f"f.TransitionUp_{i}"
            bn(p + ".NormReluConv_0.BatchNorm_0", nf)
            conv(p + ".NormReluConv_0.Conv_0", nf, nf // 2, 1)
            nf //= 2
            bn(p + ".BatchNorm_0", nf)
            conv(p + ".Conv_0", nf, nf, 3)
    p = "f.LastDecoding_0"
    bn(p + ".NormReluConv_0.BatchNorm_0", nf)
    conv(p + ".NormReluConv_0.Conv_0", nf, nf // 2, 3)
    bn(p + ".BatchNorm_0", nf // 2)
    conv(p + ".Conv_0", nf // 2, nf // 4, 3)
    bn(p + ".BatchNorm_1", nf // 4)
    conv(p + ".Conv_1", nf // 4, 2, 5)

    conv("encoder.Conv_0", 1, e["init_features"], 7)
    nf, g = e["init_features"], e["growth_rate"]
    for i, nl in enumerate(e["blocks"]):
        for j in range(nl):
            if nf + j * g > e["bn_size"] * g:
                raise ValueError("bottleneck dense layers are not written")
            p = f"encoder.DenseBlock_{i}.DenseLayer_{j}.NormReluConv_0"
            bn(p + ".BatchNorm_0", nf + j * g)
            conv(p + ".Conv_0", nf + j * g, g, 3)
        nf += nl * g
        p = f"encoder.TransitionDown_{i}"
        bn(p + ".NormReluConv_0.BatchNorm_0", nf)
        conv(p + ".NormReluConv_0.Conv_0", nf, nf // 2, 1)
        nf //= 2
        bn(p + ".NormReluConv_1.BatchNorm_0", nf)
        conv(p + ".NormReluConv_1.Conv_0", nf, nf, 3)
    side = m["grid"] // 2 ** (len(e["blocks"]) + 1)
    width = nf * side * side
    dense("encoder.Dense_0", width, width)
    dense("encoder.SplitHeads_0.Dense_0", width, zd)
    dense("encoder.SplitHeads_0.Dense_1", width, zd)
    return out


def param_spec(m: dict, n_sup: int) -> list:
    """(name, shape, init) of every trained parameter: ``normal`` (a
    standard normal over the square root of the fan-in), ``zeros``,
    ``ones``."""
    spec = []
    for name, shape in _codec_spec(m):
        if name.endswith(".weight") and len(shape) > 1:
            spec.append((name, shape, "normal"))
        elif ".BatchNorm_" in name and name.endswith(".weight"):
            spec.append((name, shape, "ones"))
        else:
            spec.append((name, shape, "zeros"))
    c = 2 * m["nx_rom"] * m["ny_rom"]
    n_free = (m["grid"] + 1) * (m["grid"] - 1)
    spec += [("g.logsigmas_y", (n_free,), "ones"),
             ("gp.logsigmas_X", (c,), "ones"),
             ("gp.Dense_0.weight", (c, m["dim_latent"]), "normal"),
             ("gp.Dense_0.bias", (c,), "zeros")]
    for q, dim in (("q_z", m["dim_latent"]), ("q_X", c)):
        spec += [(f"{q}.supervised.mean", (n_sup, dim), "zeros"),
                 (f"{q}.supervised.logsigma", (n_sup, dim), "zeros")]
    return spec


def make_weights(spec, gen: torch.Generator, dtype=torch.float32,
                 scale=None) -> dict:
    """The weights of ``spec`` on the generator's device, from one draw of
    standard normals cut into the normal leaves; ``scale`` maps a leaf's
    name to a factor on its draw."""
    scale = scale or {}
    sizes = [math.prod(s) for _, s, init in spec if init == "normal"]
    z = torch.randn(sum(sizes), generator=gen, dtype=dtype,
                    device=gen.device)
    out, lo = {}, 0
    for name, shape, init in spec:
        if init == "normal":
            n = math.prod(shape)
            fan_in = math.prod(shape[1:])
            out[name] = (z[lo:lo + n] * (scale.get(name, 1.0)
                                         / math.sqrt(fan_in))).reshape(shape)
            lo += n
        elif init == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=gen.device)
        else:
            out[name] = torch.zeros(shape, dtype=dtype, device=gen.device)
    return out


# ------------------------------------------------------------------ layers
def _same(x, k, stride):
    """Pad NCHW ``x`` for a "same" convolution: the output is
    ceil(size / stride), the padding split low-first."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def conv(W, name, x, dt, stride=1):
    w = W[name + ".weight"]
    return F.conv2d(_same(x, w.shape[-1], stride), w.to(dt), stride=stride)


def batchnorm(W, name, x, dt):
    """Flax's BatchNorm with batch statistics: the mean and the biased
    variance E[x^2] - E[x]^2 over (N, H, W), scale rsqrt(var + 1e-5) times
    the weight, in at least float32; the result in ``dt``."""
    x = x.float()
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0)
    mul = torch.rsqrt(var + 1e-5) * W[name + ".weight"]
    y = (x - mean[:, None, None]) * mul[:, None, None] \
        + W[name + ".bias"][:, None, None]
    return y.to(dt)


def nrc(W, name, x, dt, stride=1):
    """BatchNorm -> ReLU -> conv."""
    return conv(W, name + ".Conv_0",
                torch.relu(batchnorm(W, name + ".BatchNorm_0", x, dt)), dt,
                stride)


def up2(x):
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def decoder(W, m, z, dt):
    """z (B, latent) -> (mean, log-sigma), each (B, n, n) in z's dtype."""
    d = m["decoder"]
    s, c0 = d["latent_img_size"], d["latent_img_features"]
    x = z @ W["f.Dense_0.weight"].T + W["f.Dense_0.bias"]
    x = x.reshape(-1, s, s, c0).permute(0, 3, 1, 2).to(dt)
    x = conv(W, "f.Conv_0", x, dt)
    nb = len(d["blocks"])
    for i, nl in enumerate(d["blocks"]):
        for j in range(nl):
            y = nrc(W, f"f.DenseBlock_{i}.DenseLayer_{j}.NormReluConv_0",
                    x, dt)
            x = torch.cat([x, y], dim=1)
        if i < nb - 1:
            p = f"f.TransitionUp_{i}"
            x = nrc(W, p + ".NormReluConv_0", x, dt)
            x = torch.relu(batchnorm(W, p + ".BatchNorm_0", x, dt))
            x = conv(W, p + ".Conv_0", up2(x), dt)
    p = "f.LastDecoding_0"
    x = nrc(W, p + ".NormReluConv_0", x, dt)
    x = torch.relu(batchnorm(W, p + ".BatchNorm_0", x, dt))
    x = conv(W, p + ".Conv_0", up2(x), dt)
    x = conv(W, p + ".Conv_1",
             torch.relu(batchnorm(W, p + ".BatchNorm_1", x, dt)), dt)
    x = x.to(z.dtype)
    return x[:, 0], x[:, 1]


def encoder(W, m, X, dt):
    """X (B, n, n) -> (mean, log-sigma) of the latent, each (B, latent)."""
    e = m["encoder"]
    x = conv(W, "encoder.Conv_0", X[:, None].to(dt), dt, stride=2)
    for i, nl in enumerate(e["blocks"]):
        for j in range(nl):
            y = nrc(W, f"encoder.DenseBlock_{i}.DenseLayer_{j}.NormReluConv_0",
                    x, dt)
            x = torch.cat([x, y], dim=1)
        p = f"encoder.TransitionDown_{i}"
        x = nrc(W, p + ".NormReluConv_0", x, dt)
        x = nrc(W, p + ".NormReluConv_1", x, dt, stride=2)
    x = x.to(X.dtype).permute(0, 2, 3, 1).flatten(1)
    x = torch.relu(x @ W["encoder.Dense_0.weight"].T
                   + W["encoder.Dense_0.bias"])
    p = "encoder.SplitHeads_0"
    return (x @ W[p + ".Dense_0.weight"].T + W[p + ".Dense_0.bias"],
            x @ W[p + ".Dense_1.weight"].T + W[p + ".Dense_1.bias"])


def gauss_ll(target, mean, logvar):
    """Sum of Gaussian log-densities."""
    return -0.5 * torch.sum(logvar + (target - mean) ** 2 * torch.exp(-logvar)
                            + LOG_2PI)


def kld_unit(mean, logvar):
    """KL(N(mean, exp(logvar)) || N(0, 1)), summed."""
    return -0.5 * torch.sum(1 + logvar - mean ** 2 - torch.exp(logvar))


class Coarse:
    """The coarse model's fixed operators: the assembly tensor of the
    ROM grid and the interpolation to the fine free nodes."""

    def __init__(self, m: dict, device, dtype=torch.float32):
        n = m["nx_rom"]
        if m["ny_rom"] != n:
            raise ValueError("square coarse grids only")
        self.n = n
        self.M = torch.as_tensor(fem.assembly_tensor(n), dtype=dtype,
                                 device=device)
        self.W = torch.as_tensor(fem.interpolation_matrix(n, m["grid"]),
                                 dtype=dtype, device=device)

    def __call__(self, log_k, F_rom):
        y = fem.rom_solve(self.M, torch.exp(log_k) + 1e-8, F_rom, self.n)
        return y @ self.W.T


def elbo(W, m, coarse, data, draws, unsup_dt):
    """The composite ELBO and its terms: ``data`` holds the labeled
    fields ``X`` (N, n, n), labels ``Y`` (N, n_free), coarse forces
    ``F`` (N, d), the unlabeled minibatch ``Xu`` (b, n, n) and optionally
    a factor ``unsup_weight`` on the unlabeled term; ``draws``
    the standard normals of the step: ``eps_u`` (b, latent), ``eps_z``
    (N, S, latent), ``eps_X`` (N, S, c)."""
    f32 = torch.float32
    mean, logs = encoder(W, m, data["Xu"], unsup_dt)
    z = mean + torch.exp(logs) * draws["eps_u"]
    xm, xl = decoder(W, m, z, unsup_dt)
    unsup = data.get("unsup_weight", 1.0) * (
        gauss_ll(data["Xu"], xm, 2 * xl) - kld_unit(mean, 2 * logs))

    S = draws["eps_z"].shape[1]
    qzm, qzl = W["q_z.supervised.mean"], W["q_z.supervised.logsigma"]
    Z = (qzm[:, None] + torch.exp(qzl[:, None]) * draws["eps_z"]).reshape(
        -1, qzm.shape[1])
    xm, xl = decoder(W, m, Z, f32)
    X, Y, Fr = (t.repeat_interleave(S, 0)
                for t in (data["X"], data["Y"], data["F"]))
    logL_x = gauss_ll(X, xm, 2 * xl) / S
    dkl = kld_unit(qzm, 2 * qzl)
    qXm, qXl = W["q_X.supervised.mean"], W["q_X.supervised.logsigma"]
    Xs = (qXm[:, None] + torch.exp(qXl[:, None]) * draws["eps_X"]).reshape(
        -1, qXm.shape[1])
    mu_X = Z @ W["gp.Dense_0.weight"].T + W["gp.Dense_0.bias"]
    logL_X = gauss_ll(Xs, mu_X, 2 * W["gp.logsigmas_X"]) / S
    ent = qXl.sum() + qXl.numel() * 0.5 * (LOG_2PI + 1.0)
    logL_y = gauss_ll(Y, coarse(Xs, Fr), 2 * W["g.logsigmas_y"]) / S
    sup = logL_x + logL_y + logL_X + ent - dkl
    return unsup + sup, {"unsupervised": unsup, "supervised": sup}


class Adam:
    """Adam (beta 0.9 / 0.999, eps 1e-8) on a dict of tensors."""

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t, self.m, self.v = 0, {}, {}

    def step(self, W, G):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = {}
        for k, w in W.items():
            g = G[k]
            self.m[k] = self.b1 * self.m.get(k, 0) + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v.get(k, 0) + (1 - self.b2) * g * g
            mh, vh = self.m[k] / c1, self.v[k] / c2
            out[k] = w - self.lr * mh / (torch.sqrt(vh) + self.eps)
        return out


def labeled_only_leaves(W0, m, coarse, batch, unsup_dt) -> list:
    """The leaves that the unlabeled term's gradient does not reach (zero
    or absent in the reference's gradient of that term alone)."""
    Wg = {k: v.detach().clone().requires_grad_(True) for k, v in W0.items()}
    _, terms = elbo(Wg, m, coarse, batch["data"], batch["draws"], unsup_dt)
    Gu = torch.autograd.grad(terms["unsupervised"], list(Wg.values()),
                             allow_unused=True)
    return [k for k, g in zip(Wg, Gu) if g is None or not bool(g.any())]


def sgd_trace(W0, m, coarse, batches, unsup_dt, lr, steps):
    """``steps`` steps from ``W0``: (the ELBO and its terms of each step,
    the first step's gradient of -ELBO, the weights after the last)."""
    W = {k: v.detach().clone() for k, v in W0.items()}
    opt = Adam(lr)
    elbos, first = [], None
    for s in range(steps):
        Wg = {k: v.requires_grad_(True) for k, v in W.items()}
        e, terms = elbo(Wg, m, coarse, batches[s]["data"],
                        batches[s]["draws"], unsup_dt)
        G = torch.autograd.grad(-e, list(Wg.values()), allow_unused=True)
        G = {k: (torch.zeros_like(w) if g is None else g)
             for (k, w), g in zip(Wg.items(), G)}
        elbos.append({"elbo": e.item(),
                      **{k: v.item() for k, v in terms.items()}})
        if first is None:
            first = {k: g.detach() for k, g in G.items()}
        with torch.no_grad():
            W = opt.step({k: w.detach() for k, w in Wg.items()}, G)
    return elbos, first, W


def labels(X: np.ndarray, device, dtype=torch.float64, tol=1e-12,
           maxiter=20000):
    """The labels of the fields ``X`` (N, n, n) under their 'NDP'
    encodings: (free-node solutions (N, n_free), encodings (N, 4))."""
    theta = fem.ndp_thetas(X)
    u, _ = fem.solve(torch.as_tensor(X, device=device, dtype=dtype),
                     torch.as_tensor(theta, device=device, dtype=dtype),
                     tol=tol, maxiter=maxiter)
    return fem.free_values(u), theta
