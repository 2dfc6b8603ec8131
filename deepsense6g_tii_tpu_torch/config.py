"""Global configuration of the PyTorch port.

The port's own copy of ``deepsense6g_tii_tpu/config.py:18-187``: the same
frozen dataclass with the same field names and defaults, so a configuration
written for the JAX package (``GlobalConfig(FFM=0, TFM=0, ...)``) means the
same model here.  Two kernel switches keep their JAX names and pick the
hand-written kernel or the plain version for CUDA tensors:
``use_pallas_scan`` (selective scan) and ``use_flash_attention``.  Knobs
that only steer TPU lowering (``remat``, ``padded_token_stream``,
``merge_lidar_radar``, ...) are kept so that configurations carry over; the
port ignores them or raises where it does not implement them (see
models/encoder.py and models/fusion.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GlobalConfig:
    # ---- data ----
    seq_len: int = 5                 # input timesteps
    pred_len: int = 1                # beams predicted per sample (30to5: 5)
    gps_len: int = 2                 # GPS samples per sequence
    data_root: str = "./Dataset"
    n_views: int = 1                 # camera views
    input_resolution: int = 256
    scale: int = 1
    crop: int = 256
    num_beams: int = 64

    # ---- optimization ----
    lr: float = 1e-4

    # ---- Mamba toggles: Feature Fusion Mamba (vs GPT), Time Fusion Mamba ----
    FFM: int = 1
    TFM: int = 1

    # ---- modality missing ----
    modality_missing: Optional[str] = None
    modality_missing_type: str = "zerolike"

    # ---- conv encoder anchors ----
    vert_anchors: int = 8
    horz_anchors: int = 8

    # ---- GPT encoder ----
    n_embd: int = 512
    block_exp: int = 4
    n_layer: int = 8
    n_head: int = 4
    n_scale: int = 4
    embd_pdrop: float = 0.1
    resid_pdrop: float = 0.1
    attn_pdrop: float = 0.1

    # ---- Mamba block dims ----
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    # ---- data flags ----
    add_velocity: int = 1            # radar velocity map as 2nd radar channel
    add_mask: int = 0
    enhanced: int = 1
    angle_norm: int = 1
    custom_FoV_lidar: int = 1
    filtered: int = 0
    add_seg: int = 0

    # ---- execution knobs ----
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"  # activation/matmul dtype
    # hand-written selective-scan kernel (ops/selective_scan.py) for the
    # Mamba layers vs the plain doubling scan
    use_pallas_scan: bool = True
    # hand-written flash-attention kernel (ops/flash_attention.py) for the
    # GPT fusion blocks vs the plain materialised-softmax path
    use_flash_attention: bool = False
    flash_dropout_impl: Optional[str] = None
    remat: str = "none"
    # per-stage block counts for all three backbones; None = ResNet34 image,
    # ResNet18 lidar/radar
    backbone_blocks: Optional[Tuple[int, int, int, int]] = None
    merge_lidar_radar: bool = False
    merge_lr_stage1: bool = False
    padded_token_stream: bool = False
    reverse_scan_kernel: bool = False
    conv1d_impl: str = "conv"
    opt_mu_dtype: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.remat, bool):
            object.__setattr__(self, "remat", "fusion" if self.remat
                               else "none")
        if self.remat not in ("none", "fusion", "conv", "stem"):
            raise ValueError(f"remat must be 'none'|'fusion'|'conv'|'stem', "
                             f"got {self.remat!r}")
        if self.backbone_blocks is not None:
            object.__setattr__(self, "backbone_blocks",
                               tuple(self.backbone_blocks))
            if len(self.backbone_blocks) != 4:
                raise ValueError("backbone_blocks must have 4 stage counts")

    @property
    def anchors(self) -> int:
        return self.vert_anchors * self.horz_anchors

    @property
    def n_tokens(self) -> int:
        """Fused token count: 3 modalities x seq_len x anchors + gps tokens
        (962 for the 5-frame task)."""
        return (self.n_views + 2) * self.seq_len * self.anchors + self.gps_len

    def replace(self, **kw) -> "GlobalConfig":
        return dataclasses.replace(self, **kw)


# Per-scenario LiDAR field-of-view bins (x_lo, x_hi, y_lo, y_hi); own copy
# of deepsense6g_tii_tpu/config.py:189-197.
SCENARIO_FOV: Tuple[Tuple[str, Tuple[float, float, float, float]], ...] = (
    ("scenario31", (-70.0, 0.0, -25.0, 14.0)),
    ("scenario32", (-60.0, 0.0, -40.0, 5.5)),
    ("scenario33", (-50.0, 0.0, -12.0, 7.0)),
    ("scenario34", (-50.0, 0.0, -20.0, 10.0)),
)
DEFAULT_FOV: Tuple[float, float, float, float] = (-50.0, 0.0, -50.0, 50.0)

# Per-scenario base-station boresight offsets in degrees, the GPS min-max
# normalisation constants and the scenario names (config.py:200-211).
SCENARIO_ANGLE_OFFSET = {
    "scenario31": -50.52,
    "scenario32": 44.8,
    "scenario33": 55.6,
    "scenario34": -60.0,
}
POS_MAX = (40.20955233, 52.31386139)
POS_MIN = (-7.18029715, -97.55563452)

SCENARIOS = ("scenario31", "scenario32", "scenario33", "scenario34")


def config_30to5(**overrides) -> GlobalConfig:
    """The 30-to-5 multi-step variant (``deepsense6g_tii_tpu/config.py:
    214-219``): 10 input frames, 5 predicted beams, 1922 fused tokens."""
    return GlobalConfig(seq_len=10, pred_len=5, **overrides)
