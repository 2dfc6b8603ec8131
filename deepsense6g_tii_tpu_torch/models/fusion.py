"""GPT token fusion over the fused token sequence, inference mode
(``deepsense6g_tii_tpu/models/fusion.py:55-136,258-374``).

Token layout, as in the JAX package: the three (B, frames, vh, hz, C)
anchor maps are concatenated on the frame axis and flattened channels-last
(modality-major, then time, then anchors row-major), followed by the GPS
tokens: 962 tokens for the 5-frame task.

LayerNorms take eps 1e-6 (flax's default, not torch's 1e-5) and run in f32,
so their outputs are f32 as flax's are for f32 parameters; the Linears run
in the compute dtype with weights cast at call time.  Dropout is absent:
these modules serve, and the training path adds it with its kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_mha

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


class TokenFusion(nn.Module):
    """Tokenises the three anchor maps and the GPS tokens, adds the learnt
    positional embedding, runs ``n_layer`` GPT blocks and splits back."""

    def __init__(self, n_embd: int, n_layer: int, n_tokens: int,
                 n_head: int = 4, block_exp: int = 4,
                 fusion_type: str = "gpt", use_flash: bool = False,
                 dtype=torch.float32):
        super().__init__()
        if fusion_type != "gpt":
            raise NotImplementedError(
                f"fusion_type={fusion_type!r}: the port has the GPT fusion "
                "only; Mamba fusion is ROADMAP Queue 1 item 8 (MambaFuser)")
        self.pos_emb = nn.Parameter(torch.zeros(1, n_tokens, n_embd))
        for i in range(n_layer):
            self.add_module(f"block{i}", GPTBlock(n_embd, n_head, block_exp,
                                                  use_flash, dtype))
        self.ln_f = nn.LayerNorm(n_embd, eps=LN_EPS)
        self.n_layer = n_layer

    def forward(self, image, lidar, radar, gps):
        """image: (B, n_views*T, vh, hz, C); lidar/radar: (B, T, vh, hz, C);
        gps: (B, gps_tokens, C).  Returns the four streams in the same
        shapes, in f32 (the final LayerNorm's output)."""
        B, Ti, vh, hz, C = image.shape
        T = lidar.shape[1]
        tokens = torch.cat([image, lidar, radar], dim=1).reshape(B, -1, C)
        tokens = torch.cat([tokens, gps.to(tokens.dtype)], dim=1)
        x = tokens + self.pos_emb.to(tokens.dtype)
        for i in range(self.n_layer):
            x = getattr(self, f"block{i}")(x)
        x = self.ln_f(x.float())
        n_map = (Ti + 2 * T) * vh * hz
        maps = x[:, :n_map].reshape(B, Ti + 2 * T, vh, hz, C)
        return maps[:, :Ti], maps[:, Ti:Ti + T], maps[:, Ti + T:], x[:, n_map:]
