"""The full Mamba layer: projections, causal depthwise conv, selective scan
and gate (``deepsense6g_tii_tpu/ops/mamba.py:36-243``)::

    x, z = split(in_proj(h))                  # (B, L, 2*d_inner)
    x = silu(causal_depthwise_conv1d(x))
    dt, B, C = split(x_proj(x))               # dt_rank + 2*d_state
    dt = softplus(dt @ dt_proj_weight + dt_proj_bias)      # f32
    y = selective_scan(x, dt, A=-exp(A_log), B, C) + D * x
    out = out_proj(y * silu(z))

Parameter names and layouts follow the flax module, so JAX variables map
leaf by leaf (models/weights.py): ``in_proj``, ``x_proj`` and ``out_proj``
are bias-free Linears; ``dt_proj_weight`` stays (dt_rank, d_inner), ``A_log``
(d_inner, d_state); ``conv1d_weight`` takes torch's conv1d layout
(d_inner, 1, d_conv), the transpose of flax's (d_conv, 1, d_inner).

Dtypes follow the JAX package: the projections, the conv and the gate's
input run in the compute dtype; dt, A, the scan and the D skip in f32.
``use_kernel`` selects the hand-written scan kernel (ops/selective_scan.py)
for CUDA tensors, or the plain scan; CPU tensors always take the plain one.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .selective_scan import selective_scan_fwd, selective_scan_reference

INIT_STYLES = ("mamba_ssm", "gpt2")


def causal_depthwise_conv1d(x, w, bias, reverse: bool = False):
    """Depthwise width-K causal conv over time,
    ``y[b,t,c] = bias[c] + sum_j w[c,0,j] * x[b, t-(K-1)+j, c]``, or with
    ``reverse`` its anticausal mirror
    ``y[b,t,c] = bias[c] + sum_j w[c,0,j] * x[b, t+(K-1)-j, c]``.

    x: (B, L, d); w: (d, 1, K); bias: (d,).  Returns (B, L, d) contiguous in
    x's dtype."""
    K, L = w.shape[-1], x.shape[1]
    w = w.to(x.dtype)
    if reverse:
        w = w.flip(-1)
    # padding K-1 on both sides gives L+K-1 outputs: the first L are the
    # causal ones, the last L the anticausal ones of the flipped kernel
    y = F.conv1d(x.transpose(1, 2), w, bias.to(x.dtype), padding=K - 1,
                 groups=x.shape[-1])
    y = y[..., K - 1:] if reverse else y[..., :L]
    return y.transpose(1, 2).contiguous()


class ScanInputs(NamedTuple):
    """What the scan and :meth:`Mamba.post_scan` take."""

    xs: torch.Tensor      # (B, L, d_inner) conv+silu activations
    dt: torch.Tensor      # (B, L, d_inner) f32 softplus'd step sizes
    B: torch.Tensor       # (B, L, d_state)
    C: torch.Tensor       # (B, L, d_state)
    z: torch.Tensor       # (B, L, d_inner) gate branch
    A: torch.Tensor       # (d_inner, d_state) f32, -exp(A_log)


class Mamba(nn.Module):
    """Selective-state-space sequence layer over (B, L, d_model).

    ``init_style`` picks the seeded initialisation (models/fuser.py):
    "mamba_ssm" is the library's own, "gpt2" the reference fusion blocks'
    N(0, 0.02) Linears with a zero dt bias.  ``reverse`` runs the layer
    right to left over natural-order input (anticausal conv and reverse
    scan): ``Mamba(reverse=True)(x) == flip(Mamba(flip(x)))``."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, dt_rank: Optional[int] = None,
                 use_kernel: bool = True, dtype=torch.float32,
                 init_style: str = "mamba_ssm", reverse: bool = False):
        super().__init__()
        if init_style not in INIT_STYLES:
            raise ValueError(f"unknown init_style {init_style!r}")
        d_inner = expand * d_model
        self.dt_rank = dt_rank or math.ceil(d_model / 16)
        self.d_state, self.d_inner = d_state, d_inner
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.x_proj = nn.Linear(d_inner, self.dt_rank + 2 * d_state,
                                bias=False)
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)
        self.conv1d_weight = nn.Parameter(torch.empty(d_inner, 1, d_conv))
        self.conv1d_bias = nn.Parameter(torch.zeros(d_inner))
        self.dt_proj_weight = nn.Parameter(torch.empty(self.dt_rank, d_inner))
        self.dt_proj_bias = nn.Parameter(torch.zeros(d_inner))
        self.A_log = nn.Parameter(torch.empty(d_inner, d_state))
        self.D = nn.Parameter(torch.ones(d_inner))
        self.use_kernel, self.dtype = use_kernel, dtype
        self.init_style, self.reverse = init_style, reverse

    @torch.no_grad()
    def init_ssm(self, generator: torch.Generator) -> None:
        """Seeded initialisation of the layer's own parameters, after the
        JAX package's initialisers (``ops/mamba.py:36-54,178-196``): conv
        weight N(0, 1/d_conv); A_log = log(1..d_state); D = 1; conv bias 0;
        dt_proj U(+-dt_rank^-1/2) and a dt bias of softplus^-1 of
        log-uniform[1e-3, 0.1] floored at 1e-4 ("mamba_ssm"), or N(0, 0.02)
        and 0 ("gpt2").  The three projections are Linears, initialised with
        the rest of the model's (models/fuser.py)."""
        g = generator
        self.conv1d_weight.normal_(0.0, self.conv1d_weight.shape[-1] ** -0.5,
                                   generator=g)
        self.conv1d_bias.zero_()
        self.A_log.copy_(torch.log(torch.arange(
            1, self.d_state + 1, dtype=torch.float32)).expand_as(self.A_log))
        self.D.fill_(1.0)
        if self.init_style == "gpt2":
            self.dt_proj_weight.normal_(0.0, 0.02, generator=g)
            self.dt_proj_bias.zero_()
            return
        bound = self.dt_rank ** -0.5
        self.dt_proj_weight.uniform_(-bound, bound, generator=g)
        lo, hi = math.log(1e-3), math.log(0.1)
        dt = torch.exp(torch.rand(self.d_inner, generator=g) * (hi - lo) + lo)
        dt = dt.clamp(min=1e-4)
        self.dt_proj_bias.copy_(dt + torch.log(-torch.expm1(-dt)))

    def pre_scan(self, x) -> ScanInputs:
        """Projections and causal conv: everything up to the scan."""
        cdt = self.dtype
        xz = F.linear(x.to(cdt), self.in_proj.weight.to(cdt))
        xs, z = xz.split(self.d_inner, dim=-1)
        xs = F.silu(causal_depthwise_conv1d(xs, self.conv1d_weight,
                                            self.conv1d_bias, self.reverse))
        x_dbl = F.linear(xs, self.x_proj.weight.to(cdt))
        dt, B, C = x_dbl.split([self.dt_rank, self.d_state, self.d_state],
                               dim=-1)
        dt = F.softplus(torch.matmul(dt.float(), self.dt_proj_weight.float())
                        + self.dt_proj_bias.float())
        A = -torch.exp(self.A_log.float())
        return ScanInputs(xs=xs, dt=dt, B=B, C=C, z=z, A=A)

    def post_scan(self, y, pre: ScanInputs):
        """D skip, silu(z) gate and out_proj; y is the f32 scan output."""
        y = y + self.D.float() * pre.xs.float()
        y = y * F.silu(pre.z.float())
        return F.linear(y.to(self.dtype), self.out_proj.weight.to(self.dtype))

    def forward(self, x):
        pre = self.pre_scan(x)
        scan = (selective_scan_fwd if self.use_kernel
                else selective_scan_reference)
        y, _ = scan(pre.xs, pre.dt, pre.A, pre.B, pre.C, reverse=self.reverse)
        return self.post_scan(y, pre).to(x.dtype)
