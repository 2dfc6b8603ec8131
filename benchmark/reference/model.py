"""Plain PyTorch reference of the two beam-prediction models: the GPT
TransFuser (``FFM=0, TFM=0``) and the MambaFuser (``FFM=1, TFM=1``).

A frozen copy of the models' mathematics, written for the benchmark's
check of ``correct``: float32 throughout (the caller switches TF32 off),
materialised softmax attention, a plain sequential selective scan, no
hand-written kernel and nothing imported from the program.  Parameter
names follow the program's state_dict (the flax scope names), so one
dict of weights loads into both.

- ResNet34 (image) and ResNet18 (lidar, radar) backbones on NHWC input
  run as NCHW convolutions; BatchNorm uses the batch's mean and biased
  variance in train mode and the running statistics in eval mode
  (eps 1e-5).  Running statistics are not updated: nothing compared
  reads them.
- Four fusion stages, each: anchors by average pooling to 8x8, tokens
  modality-major then time then anchors, plus the GPS tokens; learnt
  positional embedding, embedding dropout, ``n_layer`` GPT blocks
  (pre-LN, ReLU MLP, attention-probability dropout from the counter hash,
  residual dropout) or MambaBlocks (channel-third swap, LayerNorm over
  the whole token grid, a forward Mamba and a Mamba over the flipped
  stream combined in flipped order); the final LayerNorm; bilinear
  upsampling back to the stage's grid; residual add.
- The temporal head: token sums (GPT) or the TimeMamba head (Mamba).
- The join MLP 512 -> 256 -> 128 -> num_beams.

``quant="fp8"`` computes every matrix product and convolution on
operands rounded to float8 e4m3 with a per-tensor scale, and rounds its
result and the output of every BatchNorm and LayerNorm the same way, as a
float8 model stores its activations (the gradient passes straight
through): the control that a lower precision than the configuration's
must fail.

Training draws dropout as the program states it draws (``DropoutDraws``):
step s seeds a device generator for the elementwise masks and a CPU
generator for the attention hash seeds from
``numpy.random.SeedSequence([rng_seed, s, 0]).generate_state(3)``; masks
are ``rand(shape) >= p``, kept values scaled by 1/(1-p); attention keeps
element (bh, row, col) when the top 24 bits of murmur3-fmix32
(((bh*t_pad + row)*t_pad + col) ^ seed), over 2^24, are >= p, with t_pad
the token count rounded up to 512.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5
LN_EPS = 1e-6
RESNET18 = (2, 2, 2, 2)
RESNET34 = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)
STRIDES = (1, 2, 2, 2)
UPSAMPLE = (8, 4, 2, 1)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
HASH_BLOCK = 512
FP8_MAX = 448.0
_U32 = 0xFFFFFFFF


# -- precision ---------------------------------------------------------------

def fp8(x):
    """``x`` rounded to float8 e4m3 under a per-tensor scale, with the
    gradient of the identity."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


class Ops:
    """The matrix products and convolutions, in float32, or on float8
    operands with float8 results (each result rounded as a float8 layer
    would store it)."""

    def __init__(self, quant=None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.q = fp8 if quant == "fp8" else (lambda x: x)

    def linear(self, x, w, b=None):
        return self.q(F.linear(self.q(x), self.q(w), b))

    def conv2d(self, x, w, stride, padding):
        return self.q(F.conv2d(self.q(x), self.q(w), stride=stride,
                               padding=padding))

    def conv1d(self, x, w, b, padding, groups):
        return self.q(F.conv1d(self.q(x), self.q(w), b, padding=padding,
                               groups=groups))

    def matmul(self, a, b):
        return self.q(torch.matmul(self.q(a), self.q(b)))


# -- dropout as the program draws it -----------------------------------------

def uniform_hash(ids, seed: int):
    """murmur3-fmix32 of (ids ^ seed) as a uniform in [0, 1) from the top
    24 bits; uint32 arithmetic in int64 masked after each product."""
    x = ids.bitwise_xor(int(seed) & _U32).bitwise_and_(_U32)
    x.bitwise_xor_(x >> 16)
    x.mul_(0x85EBCA6B).bitwise_and_(_U32)
    x.bitwise_xor_(x >> 13)
    x.mul_(0xC2B2AE35).bitwise_and_(_U32)
    x.bitwise_xor_(x >> 16)
    return (x >> 8).to(torch.float32) * 2.0 ** -24


def attention_keep(seed: int, n_bh: int, t: int, p: float, device):
    """(n_bh, t, t) bool: the attention elements the hash stream keeps."""
    t_pad = -(-t // HASH_BLOCK) * HASH_BLOCK
    bh = torch.arange(n_bh, dtype=torch.int64, device=device)[:, None, None]
    r = torch.arange(t, dtype=torch.int64, device=device)[None, :, None]
    c = torch.arange(t, dtype=torch.int64, device=device)[None, None, :]
    ids = ((bh * t_pad + r) * t_pad + c).bitwise_and_(_U32)
    return uniform_hash(ids, seed) >= np.float32(p)


class DropoutDraws:
    """The step's dropout draws, in the program's order: one device
    generator for elementwise masks, one CPU generator for the attention
    seeds.  ``rank`` extends the entropy as a process group does."""

    def __init__(self, rng_seed: int, step: int, device, micro: int = 0,
                 rank=None):
        entropy = [rng_seed, step, micro] + ([] if rank is None else [rank])
        s = np.random.SeedSequence(entropy).generate_state(3)
        self.device = torch.device(device)
        self.masks = torch.Generator(device=self.device).manual_seed(int(s[0]))
        self.seeds = torch.Generator().manual_seed(int(s[1]))

    def keep(self, shape, p: float):
        return torch.rand(shape, generator=self.masks,
                          device=self.device) >= p

    def seed(self) -> int:
        return int(torch.randint(-2 ** 31, 2 ** 31, (1,),
                                 generator=self.seeds))


def apply_keep(x, keep, p: float):
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


# -- backbones ---------------------------------------------------------------

def _same(x):
    return x


class BN(nn.Module):
    q = staticmethod(_same)             # the output's rounding (``Ops.q``)

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.batch_stats = None

    def forward(self, x):                          # NCHW
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0)
            self.batch_stats = (mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return self.q((x - mean[:, None, None]) * mul[:, None, None]
                      + self.bias[:, None, None])


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.stride, self.padding = stride, padding

    def forward(self, x, ops):
        return ops.conv2d(x, self.weight, self.stride, self.padding)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, c: int, stride: int):
        super().__init__()
        self.conv1, self.bn1 = Conv(cin, c, 3, stride, 1), BN(c)
        self.conv2, self.bn2 = Conv(c, c, 3, 1, 1), BN(c)
        if stride != 1 or cin != c:
            self.downsample_conv = Conv(cin, c, 1, stride, 0)
            self.downsample_bn = BN(c)
        else:
            self.downsample_conv = None

    def forward(self, x, ops):
        res = x if self.downsample_conv is None else self.downsample_bn(
            self.downsample_conv(x, ops))
        y = torch.relu(self.bn1(self.conv1(x, ops)))
        return torch.relu(self.bn2(self.conv2(y, ops)) + res)


class Stem(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.conv1, self.bn1 = Conv(cin, 64, 7, 2, 3), BN(64)

    def forward(self, x, ops):
        y = torch.relu(self.bn1(self.conv1(x, ops)))
        return F.max_pool2d(y, 3, 2, 1)


class Stage(nn.Module):
    def __init__(self, cin: int, c: int, n: int, stride: int):
        super().__init__()
        for i in range(n):
            self.add_module(f"block{i}", BasicBlock(cin if i == 0 else c, c,
                                                    stride if i == 0 else 1))
        self.n = n


class Backbone(nn.Module):
    def __init__(self, cin: int, blocks):
        super().__init__()
        self.stem = Stem(cin)
        ins = (64,) + WIDTHS
        for i in range(4):
            self.add_module(f"stage{i + 1}",
                            Stage(ins[i], WIDTHS[i], blocks[i], STRIDES[i]))


def run_checkpointed(fn, *args, on: bool):
    return checkpoint(fn, *args, use_reentrant=False) if on else fn(*args)


# -- fusion ------------------------------------------------------------------

class Linear(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x, ops):
        return ops.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    q = staticmethod(_same)

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return self.q(F.layer_norm(x, x.shape[-1:], self.weight, self.bias,
                                   LN_EPS))


class GPTBlock(nn.Module):
    def __init__(self, c: int, heads: int, exp: int, attn_p: float,
                 resid_p: float):
        super().__init__()
        self.ln1, self.ln2 = LayerNorm(c), LayerNorm(c)
        self.attn = nn.Module()
        for name in ("query", "key", "value", "proj"):
            self.attn.add_module(name, Linear(c, c))
        self.mlp_fc, self.mlp_proj = Linear(c, exp * c), Linear(exp * c, c)
        self.heads, self.attn_p, self.resid_p = heads, attn_p, resid_p

    def forward(self, x, ops, seed, keep_proj, keep_mlp):
        B, T, C = x.shape
        hs = C // self.heads
        h = self.ln1(x)
        q, k, v = (getattr(self.attn, n)(h, ops).reshape(
            B, T, self.heads, hs).transpose(1, 2)
            for n in ("query", "key", "value"))
        att = torch.softmax(ops.matmul(q, k.transpose(-1, -2)) * hs ** -0.5,
                            dim=-1)
        if seed is not None:
            keep = attention_keep(seed, B * self.heads, T, self.attn_p,
                                  x.device).view(B, self.heads, T, T)
            att = apply_keep(att, keep, self.attn_p)
        y = ops.matmul(att, v).transpose(1, 2).reshape(B, T, C)
        x = x + apply_keep(self.attn.proj(y, ops), keep_proj, self.resid_p)
        m = torch.relu(self.mlp_fc(self.ln2(x), ops))
        return x + apply_keep(self.mlp_proj(m, ops), keep_mlp, self.resid_p)


class LayerNorm2D(nn.Module):
    """LayerNorm over the whole (tokens, C) grid, affine per element."""

    q = staticmethod(_same)

    def __init__(self, n_tokens: int, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n_tokens, c))
        self.bias = nn.Parameter(torch.zeros(n_tokens, c))

    def forward(self, x):
        mean = x.mean(dim=(-2, -1), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(-2, -1), keepdim=True)
        return self.q((x - mean) * torch.rsqrt(var + LN_EPS) * self.weight
                      + self.bias)


class LinearRecurrence(torch.autograd.Function):
    """h_t = a_t * h_{t-1} + b_t from h_{-1} = 0, step by step over the
    leading axis; the backward runs the adjoint recurrence right to
    left."""

    @staticmethod
    def forward(ctx, a, b):                        # (L, ...)
        h = torch.empty_like(b)
        if b.is_meta:                              # shapes only
            return h
        prev = torch.zeros_like(b[0])
        for t in range(b.shape[0]):
            prev = torch.addcmul(b[t], a[t], prev, out=h[t])
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, gh):
        a, h = ctx.saved_tensors
        gb = torch.empty_like(gh)
        nxt = torch.zeros_like(gh[0])
        for t in range(gh.shape[0] - 1, -1, -1):
            # dL/dh_t = gh_t + a_{t+1} * dL/dh_{t+1}
            nxt = torch.addcmul(gh[t], a[t + 1], nxt, out=gb[t]) \
                if t + 1 < gh.shape[0] else gb[t].copy_(gh[t])
        ga = torch.zeros_like(a)
        ga[1:] = gb[1:] * h[:-1]
        return ga, gb


def selective_scan(u, dt, A, Bm, Cm):
    """y_t = C_t . h_t with h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t.
    u, dt: (b, L, d); A: (d, n); Bm, Cm: (b, L, n).  f32."""
    a = torch.exp(dt.transpose(0, 1)[..., None] * A)           # (L, b, d, n)
    bx = (dt * u).transpose(0, 1)[..., None] \
        * Bm.transpose(0, 1)[:, :, None, :]
    h = LinearRecurrence.apply(a, bx)
    return (h * Cm.transpose(0, 1)[:, :, None, :]).sum(-1).transpose(0, 1)


class Mamba(nn.Module):
    def __init__(self, c: int, d_state: int, d_conv: int, expand: int):
        super().__init__()
        di = expand * c
        self.dt_rank = math.ceil(c / 16)
        self.di, self.n = di, d_state
        self.in_proj = Linear(c, 2 * di, bias=False)
        self.x_proj = Linear(di, self.dt_rank + 2 * d_state, bias=False)
        self.out_proj = Linear(di, c, bias=False)
        self.conv1d_weight = nn.Parameter(torch.empty(di, 1, d_conv))
        self.conv1d_bias = nn.Parameter(torch.zeros(di))
        self.dt_proj_weight = nn.Parameter(torch.empty(self.dt_rank, di))
        self.dt_proj_bias = nn.Parameter(torch.zeros(di))
        self.A_log = nn.Parameter(torch.empty(di, d_state))
        self.D = nn.Parameter(torch.ones(di))

    def forward(self, x, ops):                     # (b, L, c)
        L = x.shape[1]
        xs, z = self.in_proj(x, ops).split(self.di, dim=-1)
        K = self.conv1d_weight.shape[-1]
        xs = ops.conv1d(xs.transpose(1, 2), self.conv1d_weight,
                        self.conv1d_bias, K - 1, self.di)[..., :L]
        xs = F.silu(xs.transpose(1, 2))
        dt, Bm, Cm = self.x_proj(xs, ops).split(
            [self.dt_rank, self.n, self.n], dim=-1)
        dt = F.softplus(ops.matmul(dt, self.dt_proj_weight)
                        + self.dt_proj_bias)
        y = selective_scan(xs, dt, -torch.exp(self.A_log), Bm, Cm)
        y = (y + self.D * xs) * F.silu(z)
        return self.out_proj(y, ops)


class MambaBlock(nn.Module):
    def __init__(self, c: int, n_tokens: int, d_state: int, d_conv: int,
                 expand: int):
        super().__init__()
        self.ln1 = LayerNorm2D(n_tokens, c)
        self.fc1, self.fc2 = Linear(c, c), Linear(c, c)
        self.forward_mamba = Mamba(c, d_state, d_conv, expand)
        self.backward_mamba = Mamba(c, d_state, d_conv, expand)

    def forward(self, x, ops):
        x1 = self.fc1(self.ln1(x), ops)
        fm = self.forward_mamba(x1, ops)
        x_flip = x1.flip(1)
        bm = self.backward_mamba(x_flip, ops)
        relu = F.leaky_relu(self.fc2(x_flip, ops), 0.2)
        return bm * relu + fm * bm


class TokenFusion(nn.Module):
    def __init__(self, cfg, c: int):
        super().__init__()
        n_tok = (cfg["n_views"] + 2) * cfg["seq_len"] * cfg["vert_anchors"] \
            * cfg["horz_anchors"] + cfg["gps_len"]
        self.gpt = not cfg["FFM"]
        self.pos_emb = nn.Parameter(torch.zeros(1, n_tok, c))
        for i in range(cfg["n_layer"]):
            self.add_module(f"block{i}", GPTBlock(
                c, cfg["n_head"], cfg["block_exp"], cfg["attn_pdrop"],
                cfg["resid_pdrop"]) if self.gpt else MambaBlock(
                c, n_tok, cfg["d_state"], cfg["d_conv"], cfg["expand"]))
        self.ln_f = LayerNorm(c)
        self.n_layer, self.embd_p = cfg["n_layer"], cfg["embd_pdrop"]
        self.attn_p, self.resid_p = cfg["attn_pdrop"], cfg["resid_pdrop"]

    def forward(self, image, lidar, radar, gps, ops, draws, ckpt):
        B, T, vh, hz, C = image.shape
        if not self.gpt:                           # channel thirds swap
            s1, s2 = C // 3, C // 3 * 2
            image, lidar, radar = [
                torch.cat([p[..., :s1], q[..., s1:s2], r[..., s2:]], -1)
                for p, q, r in ((image, lidar, radar), (lidar, radar, image),
                                (radar, image, lidar))]
        x = torch.cat([torch.cat([image, lidar, radar], 1).reshape(B, -1, C),
                       gps], 1) + self.pos_emb
        shape = x.shape
        if draws is not None and self.embd_p > 0:
            x = apply_keep(x, draws.keep(shape, self.embd_p), self.embd_p)
        for i in range(self.n_layer):
            blk = getattr(self, f"block{i}")
            if self.gpt:
                seed = kp = km = None
                if draws is not None:
                    seed = draws.seed() if self.attn_p > 0 else None
                    kp = draws.keep(shape, self.resid_p) \
                        if self.resid_p > 0 else None
                    km = draws.keep(shape, self.resid_p) \
                        if self.resid_p > 0 else None
                x = run_checkpointed(lambda x, kp, km, blk=blk, seed=seed:
                                     blk(x, ops, seed, kp, km),
                                     x, kp, km, on=ckpt)
            else:
                x = run_checkpointed(lambda x, blk=blk: blk(x, ops), x,
                                     on=ckpt)
        x = self.ln_f(x)
        n_map = 3 * T * vh * hz
        maps = x[:, :n_map].reshape(B, 3 * T, vh, hz, C)
        return maps[:, :T], maps[:, T:2 * T], maps[:, 2 * T:], x[:, n_map:]


class TimeMamba(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.mamba = Mamba(512, cfg["d_state"], cfg["d_conv"], cfg["expand"])
        self.mlp = Linear(cfg["seq_len"], cfg["seq_len"])
        self.mlp_gps = Linear(cfg["gps_len"], cfg["gps_len"])

    @staticmethod
    def pool_attend(f, dense, ops):
        att = torch.softmax(dense(f.amax(-1) + f.mean(-1), ops), dim=-1)
        return (f * att[..., None]).sum(1)

    def forward(self, image, lidar, radar, gps, ops):
        outs = [self.pool_attend(self.mamba(f, ops), self.mlp, ops)
                for f in (image, lidar, radar)]
        return sum(outs + [self.pool_attend(gps, self.mlp_gps, ops)])


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        blocks = cfg.get("backbone_blocks")
        self.image_encoder = Backbone(3, blocks or RESNET34)
        self.lidar_encoder = Backbone(1, blocks or RESNET18)
        self.radar_encoder = Backbone(2 if cfg["add_velocity"] else 1,
                                      blocks or RESNET18)
        gps_in = (2,) + WIDTHS[:3]
        for i in range(4):
            self.add_module(f"vel_emb{i + 1}", Linear(gps_in[i], WIDTHS[i]))
            self.add_module(f"fusion{i + 1}", TokenFusion(cfg, WIDTHS[i]))
        if cfg["TFM"]:
            self.time_mamba = TimeMamba(cfg)
        self.cfg = cfg


class BeamFuserReference(nn.Module):
    """The whole model.  ``forward(image, lidar, radar, gps)`` takes NHWC
    sensor tensors (B, T, H, W, C) and (B, gps_len, 2) and returns (B,
    num_beams) float32 logits.  In train mode ``draws`` (a
    :class:`DropoutDraws`) supplies the dropout; ``checkpointed``
    recomputes each residual block, GPT block and MambaBlock in the
    backward so that a full-size batch fits."""

    def __init__(self, cfg: dict, quant=None, checkpointed: bool = False):
        super().__init__()
        self.encoder = Encoder(cfg)
        self.join_fc1 = Linear(512, 256)
        self.join_fc2 = Linear(256, 128)
        self.join_fc3 = Linear(128, cfg["num_beams"])
        self.cfg, self.ops = cfg, Ops(quant)
        self.checkpointed = checkpointed
        if quant is not None:
            for m in self.modules():
                if isinstance(m, (BN, LayerNorm, LayerNorm2D)):
                    m.q = self.ops.q

    def _backbone(self, bb, x, i):
        ops, ck = self.ops, self.checkpointed and self.training
        if i == 0:
            x = run_checkpointed(lambda x: bb.stem(x, ops), x, on=ck)
        stage = getattr(bb, f"stage{i + 1}")
        for j in range(stage.n):
            blk = getattr(stage, f"block{j}")
            x = run_checkpointed(lambda x, blk=blk: blk(x, ops), x, on=ck)
        return x

    def forward(self, image, lidar, radar, gps, draws=None):
        cfg, ops, enc = self.cfg, self.ops, self.encoder
        B, T = image.shape[:2]
        mean = torch.tensor(IMAGENET_MEAN, device=image.device)
        std = torch.tensor(IMAGENET_STD, device=image.device)
        streams = [(image / 255.0 - mean) / std, lidar, radar]
        feats = [x.flatten(0, 1).permute(0, 3, 1, 2) for x in streams]
        bbs = (enc.image_encoder, enc.lidar_encoder, enc.radar_encoder)
        feats = [self._backbone(bb, f, 0) for bb, f in zip(bbs, feats)]
        vh, hz = cfg["vert_anchors"], cfg["horz_anchors"]
        g = gps
        ck = self.checkpointed and self.training
        for i in range(4):
            anchors = [F.adaptive_avg_pool2d(f, (vh, hz)).permute(0, 2, 3, 1)
                       .reshape(B, T, vh, hz, -1) for f in feats]
            emb = getattr(enc, f"vel_emb{i + 1}")(g, ops)
            *outs, g = getattr(enc, f"fusion{i + 1}")(
                *anchors, emb, ops, draws if self.training else None, ck)
            outs = [o.flatten(0, 1).permute(0, 3, 1, 2) for o in outs]
            if UPSAMPLE[i] > 1:
                outs = [F.interpolate(o, scale_factor=UPSAMPLE[i],
                                      mode="bilinear", align_corners=False)
                        for o in outs]
            feats = [f + o for f, o in zip(feats, outs)]
            if i < 3:
                feats = [self._backbone(bb, f, i + 1)
                         for bb, f in zip(bbs, feats)]
        tracks = [f.mean(dim=(2, 3)).reshape(B, T, -1) for f in feats]
        if cfg["TFM"]:
            z = enc.time_mamba(*tracks, g, ops)
        else:
            z = sum(t.sum(1) for t in tracks) + g.sum(1)
        z = torch.relu(self.join_fc1(z, ops))
        z = torch.relu(self.join_fc2(z, ops))
        return self.join_fc3(z, ops)
