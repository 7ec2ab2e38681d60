"""Wan model size configs and the default latent geometry.

The port keeps its own copy of ``self_forcing_tpu/models/wan/configs.py``
(same fields, same defaults) so that it imports nothing of the JAX
package.

- Wan2.1-T2V-1.3B: dim 1536, 30 layers, 12 heads, ffn 8960
- Wan2.1 14B: dim 5120, 40 layers, 40 heads, ffn 13824
- Wan2.1-I2V-14B: the 14B with ``model_type='i2v'`` and ``in_dim`` 36 (16
  latent channels + the 4-channel first-frame mask + its 16-channel latent)
- tiny: a CPU-testable geometry
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WanConfig:
    model_type: str = "t2v"          # 't2v' | 'i2v'
    patch_size: tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 16
    dim: int = 1536
    ffn_dim: int = 8960
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 12
    num_layers: int = 30
    local_attn_size: int = -1        # frames; -1 = global attention
    sink_size: int = 0
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6
    num_frame_per_block: int = 1
    independent_first_frame: bool = False
    # int8 decode attention (demo config): 'int8qk' runs QK^T in int8 with
    # per-tile scales and P.V in bf16 (with the 'free' softmax); 'int8'
    # runs both products in int8 ('tile' / 'global' with a score bound,
    # online without)
    attn_quant: str | None = None
    # Decode softmax mode of the attention kernels.  'free' (default):
    # head_dim**-0.5 * log2(e) is folded into the q-norm gain and the
    # kernel computes p = 2^min(s, 80) with no stability offset (qk-normed
    # scores stay far inside exp2's range).  On the CPU the plain path
    # runs the ordinary base-e softmax at head_dim**-0.5, as the JAX
    # package does off the TPU.
    attn_softmax: str = "free"
    # Windowed-streaming KV buffer in frames (>= local_attn_size; None =
    # local_attn_size).  A larger buffer lets blocks append without
    # eviction (attention reads the sink frames and the recent window as
    # two intervals) until it fills; then one compaction moves [sinks |
    # recent] to the front.  With buffer == window it compacts every
    # steady-state block, as the reference's per-block eviction does.
    windowed_buffer_frames: int | None = None
    # Tensor parallelism (parallel/tensor.py): the process group whose
    # ranks each hold a shard of the heads and ffn columns.  When set,
    # num_heads / ffn_dim are the rank's own shares, and the blocks
    # all-reduce the row-sharded products (attention o, ffn fc2) and the
    # q/k RMS-norm statistics over it.  None: one device.
    tp_group: object | None = None
    # set by parallel/tensor.tp_local_config: under tensor parallelism
    # num_heads is the rank's head count while dim stays the model width,
    # so head_dim is no longer dim // num_heads
    head_dim_override: int | None = None

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.dim // self.num_heads

    def max_attention_size(self, frame_seqlen: int) -> int:
        """Attention window in tokens: 21 frames when global, else
        local_attn_size frames."""
        if self.local_attn_size == -1:
            return 21 * frame_seqlen
        return self.local_attn_size * frame_seqlen

    @property
    def buffer_frames(self) -> int:
        """Windowed KV buffer size in frames (windowed mode only)."""
        if self.local_attn_size == -1:
            raise ValueError("buffer_frames: not a windowed config")
        bf = (self.local_attn_size if self.windowed_buffer_frames is None
              else self.windowed_buffer_frames)
        if bf < self.local_attn_size:
            raise ValueError("windowed_buffer_frames must be >= "
                             "local_attn_size")
        return bf


def apply_model_kwargs(cfg: WanConfig, config) -> WanConfig:
    """Overlay the YAML config's ``model_kwargs`` architecture keys that
    are WanConfig fields (the windowed-streaming, block and attention
    knobs) onto ``cfg``."""
    mk = getattr(config, "model_kwargs", None) or {}
    fields = {"local_attn_size", "sink_size", "windowed_buffer_frames",
              "num_frame_per_block", "independent_first_frame",
              "attn_quant", "attn_softmax"}
    over = {k: v for k, v in dict(mk).items() if k in fields}
    return dataclasses.replace(cfg, **over) if over else cfg


WAN_1_3B = WanConfig()

WAN_14B = WanConfig(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40)

# 2-head, 2-layer toy geometry; head_dim 64 keeps the f/h/w rope split valid.
WAN_TINY = WanConfig(dim=128, ffn_dim=256, num_heads=2, num_layers=2,
                     text_dim=64, freq_dim=32)

# Default latent geometry for 81 frames @ 480x832 (noise [B, 21, 16, 60, 104]).
LATENT_FRAMES = 21
LATENT_HEIGHT = 60
LATENT_WIDTH = 104
FRAME_SEQLEN = (LATENT_HEIGHT // 2) * (LATENT_WIDTH // 2)  # 1560
SEQ_LEN = LATENT_FRAMES * FRAME_SEQLEN                     # 32760

# The reference's registries of models and sizes (WAN_CONFIGS /
# SIZE_CONFIGS / MAX_AREA_CONFIGS / SUPPORTED_SIZES), so that callers of
# wan_generate.py select a model and a size by the same keys.
WAN_I2V_14B = dataclasses.replace(WAN_14B, model_type="i2v", in_dim=36)

WAN_CONFIGS = {
    "t2v-14B": WAN_14B,
    "t2v-1.3B": WAN_1_3B,
    "i2v-14B": WAN_I2V_14B,
    "t2i-14B": WAN_14B,
}

SIZE_CONFIGS = {
    "720*1280": (720, 1280),
    "1280*720": (1280, 720),
    "480*832": (480, 832),
    "832*480": (832, 480),
    "1024*1024": (1024, 1024),
}

MAX_AREA_CONFIGS = {
    "720*1280": 720 * 1280,
    "1280*720": 1280 * 720,
    "480*832": 480 * 832,
    "832*480": 832 * 480,
}

SUPPORTED_SIZES = {
    "t2v-14B": ("720*1280", "1280*720", "480*832", "832*480"),
    "t2v-1.3B": ("480*832", "832*480"),
    "i2v-14B": ("720*1280", "1280*720", "480*832", "832*480"),
    "t2i-14B": tuple(SIZE_CONFIGS.keys()),
}
