"""Token fusion over the fused token sequence, inference mode
(``deepsense6g_tii_tpu/models/fusion.py:55-416``): GPT blocks, the
bi-directional MambaBlocks and the TimeMamba temporal head.

Token layout, as in the JAX package: the three (B, frames, vh, hz, C)
anchor maps are concatenated on the frame axis and flattened channels-last
(modality-major, then time, then anchors row-major), followed by the GPS
tokens: 962 tokens for the 5-frame task.

LayerNorms take eps 1e-6 (flax's default, not torch's 1e-5) and run in f32,
so their outputs are f32 as flax's are for f32 parameters; the Linears run
in the compute dtype with weights cast at call time.  Dropout is absent:
these modules serve, and the training path adds it with its kernels.

MambaBlock parity: the reference combines the forward-order branch with the
*flipped-order* backward branch without un-flipping it
(``x_bm * leaky_relu(fc2(flip(x_fc1))) + x_fm * x_bm``, x_bm in reversed
token order); the port reproduces exactly that.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_mha
from ..ops.mamba import Mamba

LN_EPS = 1e-6


def dense(layer: nn.Linear, x, dtype):
    """``layer`` applied in ``dtype`` (flax ``nn.Dense(dtype=...)``)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class SelfAttention(nn.Module):
    """Unmasked multi-head self-attention.  The q/k/v projections keep three
    separate parameter pairs and are concatenated at apply time into one
    matmul, as in the JAX package.  ``use_flash`` runs the hand-written
    flash kernel (ops/flash_attention.py); otherwise the scores are
    materialised and softmaxed in f32 (``fusion.py:100-103``)."""

    def __init__(self, n_embd: int, n_head: int, use_flash: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.query = nn.Linear(n_embd, n_embd)
        self.key = nn.Linear(n_embd, n_embd)
        self.value = nn.Linear(n_embd, n_embd)
        self.proj = nn.Linear(n_embd, n_embd)
        self.n_head, self.use_flash, self.dtype = n_head, use_flash, dtype

    def forward(self, x):
        B, T, C = x.shape
        hs = C // self.n_head
        dt = self.dtype
        w = torch.cat([self.query.weight, self.key.weight, self.value.weight])
        b = torch.cat([self.query.bias, self.key.bias, self.value.bias])
        qkv = F.linear(x.to(dt), w.to(dt), b.to(dt))
        q, k, v = (y.reshape(B, T, self.n_head, hs).transpose(1, 2).contiguous()
                   for y in qkv.split(C, dim=-1))
        if self.use_flash:
            y = flash_mha(q, k, v, sm_scale=hs ** -0.5)
        else:
            att = torch.matmul(q, k.transpose(-1, -2)) * hs ** -0.5
            att = torch.softmax(att.float(), dim=-1).to(x.dtype)
            y = torch.matmul(att, v.to(att.dtype))
        y = y.transpose(1, 2).reshape(B, T, C)
        return dense(self.proj, y, dt)


class GPTBlock(nn.Module):
    """Pre-LN attention + ReLU MLP block."""

    def __init__(self, n_embd: int, n_head: int, block_exp: int,
                 use_flash: bool = False, dtype=torch.float32):
        super().__init__()
        self.ln1 = nn.LayerNorm(n_embd, eps=LN_EPS)
        self.attn = SelfAttention(n_embd, n_head, use_flash, dtype)
        self.ln2 = nn.LayerNorm(n_embd, eps=LN_EPS)
        self.mlp_fc = nn.Linear(n_embd, block_exp * n_embd)
        self.mlp_proj = nn.Linear(block_exp * n_embd, n_embd)
        self.dtype = dtype

    def forward(self, x):
        x = x + self.attn(self.ln1(x.float()))
        h = torch.relu(dense(self.mlp_fc, self.ln2(x.float()), self.dtype))
        return x + dense(self.mlp_proj, h, self.dtype)


class LayerNorm2D(nn.Module):
    """LayerNorm over the whole (n_tokens, C) trailing shape with a
    per-(token, channel) affine, in f32, with flax's statistics
    (``nn.LayerNorm(reduction_axes=(-2, -1), feature_axes=(-2, -1))``:
    var = mean(x^2) - mean(x)^2, floored at 0).  Written as reductions
    because torch's LayerNorm kernel gives each normalised row to one
    block: one block per batch row over 962 x C values."""

    def __init__(self, n_tokens: int, n_embd: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n_tokens, n_embd))
        self.bias = nn.Parameter(torch.zeros(n_tokens, n_embd))

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=(-2, -1), keepdim=True)
        var = (x * x).mean(dim=(-2, -1), keepdim=True) - mean * mean
        mul = torch.rsqrt(var.clamp(min=0.0) + LN_EPS) * self.weight
        return (x - mean) * mul + self.bias


class MambaBlock(nn.Module):
    """Bi-branch Mamba block (``fusion.py:170-255``): a LayerNorm over the
    whole (n_tokens, C) trailing shape with a per-(token, channel) affine,
    ``fc1``, a forward-order Mamba, and a backward branch (Mamba and
    ``fc2``) on the flipped stream, combined in flipped order (module
    docstring).  ``reverse_kernel`` runs the backward branch as a reverse
    Mamba over the natural-order stream and flips its two outputs instead
    of the input: the same parameters and math."""

    def __init__(self, n_embd: int, n_tokens: int, d_state: int = 16,
                 d_conv: int = 4, expand: int = 2, use_kernel: bool = True,
                 reverse_kernel: bool = False, dtype=torch.float32):
        super().__init__()
        self.ln1 = LayerNorm2D(n_tokens, n_embd)
        self.fc1 = nn.Linear(n_embd, n_embd)
        self.forward_mamba, self.backward_mamba = (
            Mamba(n_embd, d_state, d_conv, expand, use_kernel=use_kernel,
                  dtype=dtype, init_style="gpt2", reverse=rev)
            for rev in (False, reverse_kernel))
        self.fc2 = nn.Linear(n_embd, n_embd)
        self.reverse_kernel, self.dtype = reverse_kernel, dtype

    def forward(self, x):
        x_fc1 = dense(self.fc1, self.ln1(x), self.dtype)
        x_fm = self.forward_mamba(x_fc1)
        if self.reverse_kernel:
            x_bm = self.backward_mamba(x_fc1).flip(1)
            x_relu = F.leaky_relu(dense(self.fc2, x_fc1, self.dtype),
                                  0.2).flip(1)
        else:
            x_flip = x_fc1.flip(1)
            x_bm = self.backward_mamba(x_flip)
            x_relu = F.leaky_relu(dense(self.fc2, x_flip, self.dtype), 0.2)
        return x_bm * x_relu + x_fm * x_bm


class TokenFusion(nn.Module):
    """Tokenises the three anchor maps and the GPS tokens, adds the learnt
    positional embedding, runs ``n_layer`` GPT blocks or MambaBlocks
    (``fusion_type``) and splits back.  ``channel_swap`` (Mamba fusion
    only) first rotates channel thirds between the modalities, the
    "cs-bimamba" variant (``fusion.py:309-322``).

    ``padded_stream`` (config.padded_token_stream) is a TPU lowering knob
    that the port does not take for the Mamba fusion: it raises."""

    def __init__(self, n_embd: int, n_layer: int, n_tokens: int,
                 n_head: int = 4, block_exp: int = 4,
                 fusion_type: str = "gpt", use_flash: bool = False,
                 dtype=torch.float32, *, channel_swap: bool = True,
                 d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 use_scan_kernel: bool = True,
                 reverse_scan_kernel: bool = False,
                 padded_stream: bool = False):
        super().__init__()
        if fusion_type == "gpt":
            make_block = lambda: GPTBlock(n_embd, n_head, block_exp,  # noqa: E731
                                          use_flash, dtype)
        elif fusion_type == "mamba":
            if padded_stream:
                raise NotImplementedError(
                    "padded_token_stream is a TPU lowering knob the PyTorch "
                    "port does not take (ROADMAP.md Queue 1, Out of scope)")
            make_block = lambda: MambaBlock(  # noqa: E731
                n_embd, n_tokens, d_state, d_conv, expand, use_scan_kernel,
                reverse_scan_kernel, dtype)
        else:
            raise ValueError(f"unknown fusion_type {fusion_type!r}")
        self.pos_emb = nn.Parameter(torch.zeros(1, n_tokens, n_embd))
        for i in range(n_layer):
            self.add_module(f"block{i}", make_block())
        self.ln_f = nn.LayerNorm(n_embd, eps=LN_EPS)
        self.n_layer = n_layer
        self.channel_swap = channel_swap and fusion_type == "mamba"

    def forward(self, image, lidar, radar, gps):
        """image: (B, n_views*T, vh, hz, C); lidar/radar: (B, T, vh, hz, C);
        gps: (B, gps_tokens, C).  Returns the four streams in the same
        shapes, in f32 (the final LayerNorm's output)."""
        B, Ti, vh, hz, C = image.shape
        T = lidar.shape[1]
        if self.channel_swap:
            if Ti != T:
                raise ValueError(
                    f"channel_swap rotates channel thirds across same-shape "
                    f"modality tracks; image has {Ti} frames vs {T} "
                    f"(n_views must be 1)")
            s1, s2 = C // 3, C // 3 * 2
            image, lidar, radar = [
                torch.cat([p[..., :s1], q[..., s1:s2], r[..., s2:]], dim=-1)
                for p, q, r in ((image, lidar, radar), (lidar, radar, image),
                                (radar, image, lidar))]
        tokens = torch.cat([image, lidar, radar], dim=1).reshape(B, -1, C)
        tokens = torch.cat([tokens, gps.to(tokens.dtype)], dim=1)
        x = tokens + self.pos_emb.to(tokens.dtype)
        for i in range(self.n_layer):
            x = getattr(self, f"block{i}")(x)
        x = self.ln_f(x.float())
        n_map = (Ti + 2 * T) * vh * hz
        maps = x[:, :n_map].reshape(B, Ti + 2 * T, vh, hz, C)
        return maps[:, :Ti], maps[:, Ti:Ti + T], maps[:, Ti + T:], x[:, n_map:]


class TimeMamba(nn.Module):
    """Temporal fusion head (``fusion.py:377-416``): one shared Mamba
    ("mamba_ssm" init) over each modality's (B, T, C) track, a per-modality
    attention over time from (max + mean over channels) through ``mlp`` and
    a softmax, a weighted sum to one token each, and the sum of the three
    tokens and the GPS tokens' own pool-attend (``mlp_gps``): (B, C), f32.

    The JAX package forces the plain scan here, because its 128-step TPU
    chunk would pad 5 steps to 128; the CUDA kernel takes any L, so the
    head follows ``use_kernel`` like the fusion blocks."""

    def __init__(self, d_model: int = 512, seq_len: int = 5,
                 gps_tokens: int = 2, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, use_kernel: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.mamba = Mamba(d_model, d_state, d_conv, expand,
                           use_kernel=use_kernel, dtype=dtype)
        self.mlp = nn.Linear(seq_len, seq_len)
        self.mlp_gps = nn.Linear(gps_tokens, gps_tokens)

    @staticmethod
    def _pool_attend(feats, dense_layer):
        att = feats.amax(dim=-1) + feats.mean(dim=-1)             # (B, T)
        att = torch.softmax(dense_layer(att), dim=-1)
        return (feats * att[..., None]).sum(dim=1)                # (B, C)

    def forward(self, image, lidar, radar, gps):
        """image/lidar/radar: (B, T, C) f32 tracks; gps: (B, gps_tokens, C)
        f32."""
        outs = [self._pool_attend(self.mamba(f), self.mlp)
                for f in (image, lidar, radar)]
        return sum(outs + [self._pool_attend(gps, self.mlp_gps)])
