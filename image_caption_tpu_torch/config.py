"""Typed configuration: the model presets and the special vocabulary tokens.

The port's own copy of ``image_caption_tpu/config.py``, so that the PyTorch
package needs nothing of the JAX one.  Every experiment of the reference
(shao-chi/Image-Caption, ``core/config.py:71-695``) is a frozen dataclass
preset, selectable by name and overridable field by field.

``model.architecture`` picks the captioner: ``"transformer"`` (every
preset of the reference) or ``"mla_moe"``, a decoder-only language model
with latent attention and routed experts over the region slots
(``models/lm.py``), sized by the ``lm`` section; the port alone has it.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

# ---------------------------------------------------------------------------
# Special vocabulary tokens (core/preprocess.py:303)
# ---------------------------------------------------------------------------
NULL_TOKEN = "<NULL>"
START_TOKEN = "<START>"
END_TOKEN = "<END>"
UNK_TOKEN = "<UNK>"

NULL_IDX = 0
START_IDX = 1
END_IDX = 2
UNK_IDX = 3


@dataclass(frozen=True)
class ModelConfig:
    """Captioner architecture (reference: core/TRANSFORMER/model.py:10-36).

    ``max_length`` is the caption vector length, MAX_LENGTH + 2 slots for
    <START>/<END> (core/models.py:88); the decoder's positional table spans
    ``max_length - 1`` positions (model.py:383).
    """

    num_vocab: int = 12_000
    max_length: int = 51
    num_objects: int = 36
    dim_features: int = 2048
    dim_positions: int = 84              # YOLOv5: 4 xyxy + 80 class*conf
    pad_idx: int = 0
    dropout: float = 0.3
    attention_dropout: float = 0.1

    encode_input_size: int = 256
    encode_q_k_dim: int = 256
    encode_v_dim: int = 256
    encode_hidden_size: int = 256
    encode_num_blocks: int = 2
    encode_num_heads: int = 32

    dim_word_embedding: int = 256
    decode_input_size: int = 256
    decode_q_k_dim: int = 256
    decode_v_dim: int = 256
    decode_hidden_size: int = 256
    decode_num_blocks: int = 5
    decode_num_heads: int = 32

    # behaviour flags (core/config.py:16-19)
    move_first_image_feature: bool = False
    split_position: bool = False
    encode_mask: bool = True
    split_image_objects: bool = True

    # loss selection: 'cross_entropy' | 'focal' (model.py:73-76)
    xe_loss: str = "cross_entropy"
    focal_gamma: float = 2.0

    # numerics: compute dtype for matmuls; params stay f32
    compute_dtype: str = "float32"

    # 'transformer' (models/captioner.py) | 'mla_moe' (models/lm.py, sized
    # by Config.lm)
    architecture: str = "transformer"

    def __post_init__(self):
        if self.architecture not in ARCHITECTURES:
            raise ValueError(f"unknown architecture {self.architecture!r}")
        if self.encode_q_k_dim % self.encode_num_heads or \
                self.encode_v_dim % self.encode_num_heads:
            raise ValueError("encoder widths must divide by the head count")
        if self.decode_q_k_dim % self.decode_num_heads or \
                self.decode_v_dim % self.decode_num_heads:
            raise ValueError("decoder widths must divide by the head count")
        if self.xe_loss not in ("cross_entropy", "focal"):
            raise ValueError(f"unknown xe_loss {self.xe_loss!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")

    @property
    def num_slots(self) -> int:
        """Object slots incl. the whole-image slot (NUM_OBJECT + 1)."""
        return self.num_objects + 1


ARCHITECTURES = ("transformer", "mla_moe")


@dataclass(frozen=True)
class LMConfig:
    """The ``mla_moe`` captioner's text model, in the names of DeepSeek-V3's
    ``config.json`` (the defaults: Kimi-VL-A3B-Instruct's ``text_config``),
    and the projector that maps a region slot (``dim_features +
    dim_positions`` wide) into it.  Only what that model uses is
    supported: no query LoRA, one expert group, sigmoid scores, the
    chosen scores normalised."""

    hidden_size: int = 2048
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11_264        # the leading dense layers
    first_k_dense_replace: int = 1
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800_000.0
    projector_hidden_size: int = 4608

    def __post_init__(self):
        if self.kv_lora_rank <= 0 or self.qk_nope_head_dim <= 0 or \
                self.v_head_dim <= 0 or self.num_attention_heads <= 0:
            raise ValueError("attention sizes must be positive")
        if self.qk_rope_head_dim <= 0 or self.qk_rope_head_dim % 2:
            raise ValueError("qk_rope_head_dim must be positive and even")
        if not 0 < self.num_experts_per_tok <= self.n_routed_experts:
            raise ValueError("num_experts_per_tok must lie in "
                             "1..n_routed_experts")
        if not 0 <= self.first_k_dense_replace <= self.num_hidden_layers:
            raise ValueError("first_k_dense_replace exceeds the layers")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class RLConfig:
    """Self-critical loss weights (core/config.py:80-86)."""

    structure_loss_weight: float = 0.5
    cider_reward_weight: float = 1.0
    bleu_reward_weight: float = 1.0
    entropy_reward_weight: float = 1.0
    self_cider_reward_weight: float = 1.0
    sample_mode: str = "argmax"          # 'argmax' | 'categorical'
    num_samples: int = 1
    pipeline_depth: int = 1


@dataclass(frozen=True)
class TrainConfig:
    """Solver settings (core/config.py:59-68)."""

    num_epochs: int = 1000
    batch_size: int = 32
    learning_rate: float = 5e-4
    seed: int = 0
    log_every: int = 100
    sample_every: int = 2500
    scan_steps: int = 1
    data_axis: int = -1
    model_axis: int = 1
    donate_state: bool = True
    checkpoint_every_epochs: int = 1
    keep_checkpoints: int = 5


@dataclass(frozen=True)
class DataConfig:
    """Dataset layout (core/utils.py:32-64, core/config.py:21-27)."""

    data_path: str = "./data/maxlen49_36obj_1wordCount"
    output_path: str = "./output/default"
    max_caption_words: int = 49
    word_count_threshold: int = 1
    max_obj: int = 5
    image_model: str = "YOLOv5"          # 'YOLOv5' | 'FasterRCNN'
    stream_features: str = "auto"        # 'auto' | 'never' | 'always'
    rect_letterbox: bool = False
    feature_mode: str = "crop"           # 'crop' | 'roi'
    roi_trunk_size: int = 448
    roi_detect_size: int = 320

    @property
    def word_to_idx_path(self) -> str:
        return f"{self.data_path}/train/word_index.pkl"


@dataclass(frozen=True)
class Config:
    name: str = "default"
    caption_model: str = "Transformer"   # 'Transformer' | 'RL_Transformer'
    model: ModelConfig = field(default_factory=ModelConfig)
    rl: RLConfig = field(default_factory=RLConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    lm: LMConfig = field(default_factory=LMConfig)

    def __post_init__(self):
        if self.model.architecture == "mla_moe":
            if self.model.max_length < 2:
                # the latent cache holds the slots, <START> and the fed
                # tokens: max_length - 1 positions after the slots
                raise ValueError("an mla_moe captioner needs max_length >= 2")
            if self.model.num_vocab <= UNK_IDX:
                raise ValueError("the vocabulary must hold the special ids")

    def with_overrides(self, **kwargs) -> "Config":
        """Apply dotted overrides, e.g. ``model.dropout=0.1``.  The fields of
        one section change together, so a width and its head count may
        change in one call whatever their order."""
        top, sections = {}, {}
        for key, value in kwargs.items():
            if "." in key:
                section, leaf = key.split(".", 1)
                sections.setdefault(section, {})[leaf] = value
            else:
                top[key] = value
        for section, leaves in sections.items():
            top[section] = replace(getattr(self, section), **leaves)
        return replace(self, **top)


# ---------------------------------------------------------------------------
# Preset registry mirroring the reference's OUTPUT_NAME blocks
# ---------------------------------------------------------------------------

def _d256_25b_32h(**kw) -> ModelConfig:
    """The 256-wide enc2/dec5 32-head family (core/config.py:87-102)."""
    base = dict(
        encode_input_size=256, encode_q_k_dim=256, encode_v_dim=256,
        encode_hidden_size=256, encode_num_blocks=2, encode_num_heads=32,
        dim_word_embedding=256, decode_input_size=256, decode_q_k_dim=256,
        decode_v_dim=256, decode_hidden_size=256, decode_num_blocks=5,
        decode_num_heads=32,
    )
    base.update(kw)
    return ModelConfig(**base)


def _d128_14b_16h(**kw) -> ModelConfig:
    """128-wide enc1/dec4 family, FFN 256 (core/config.py:476-500,526-552)."""
    base = dict(
        encode_input_size=128, encode_q_k_dim=128, encode_v_dim=128,
        encode_hidden_size=256, encode_num_blocks=1, encode_num_heads=16,
        dim_word_embedding=256, decode_input_size=128, decode_q_k_dim=128,
        decode_v_dim=128, decode_hidden_size=256, decode_num_blocks=4,
        decode_num_heads=16, split_image_objects=False)
    base.update(kw)
    return ModelConfig(**base)


_PRESETS: dict[str, Config] = {}


def register_preset(cfg: Config) -> Config:
    if cfg.name in _PRESETS:
        raise ValueError(f"preset {cfg.name!r} registered twice")
    _PRESETS[cfg.name] = cfg
    return cfg


def get_preset(name: str) -> Config:
    if name not in _PRESETS:
        raise KeyError(
            f"Unknown preset {name!r}. Available: {sorted(_PRESETS)}")
    return _PRESETS[name]


def list_presets() -> list[str]:
    return sorted(_PRESETS)


# The shipped default (core/config.py:71-102): RL, encoder causal mask on,
# split-image-objects pairing on.
FLAGSHIP = register_preset(Config(
    name="RL_maxlen49_36obj_1wordCount_256_25b_32h_split_img_obj",
    caption_model="RL_Transformer",
    model=_d256_25b_32h(encode_mask=True, split_image_objects=True),
))

register_preset(Config(
    name="maxlen49_36obj_1wordCount_256_25b_32h_split_img_obj",
    caption_model="Transformer",
    model=_d256_25b_32h(encode_mask=True, split_image_objects=True),
))

register_preset(Config(
    name="RL_maxlen49_36obj_1wordCount_256_25b_32h_move",
    caption_model="RL_Transformer",
    model=_d256_25b_32h(move_first_image_feature=True,
                        encode_mask=True, split_image_objects=False),
))

register_preset(Config(
    name="RL_maxlen49_36obj_1wordCount_256_25b_32h_move_2",
    caption_model="RL_Transformer",
    model=_d256_25b_32h(move_first_image_feature=True,
                        encode_mask=True, split_image_objects=False),
    rl=RLConfig(structure_loss_weight=0.7),
))

register_preset(Config(
    name="maxlen49_36obj_1wordCount_20conf_256_25b_32h_move",
    caption_model="Transformer",
    model=_d256_25b_32h(move_first_image_feature=True,
                        encode_mask=True, split_image_objects=False),
))

register_preset(Config(
    name="maxlen49_36obj_1wordCount_256_25b_32h_RL",
    caption_model="RL_Transformer",
    model=_d256_25b_32h(move_first_image_feature=True,
                        encode_mask=False, split_image_objects=False),
))

register_preset(Config(
    name="maxlen49_36obj_1wordCount_256_25b_32h_EncoderMask",
    caption_model="Transformer",
    model=_d256_25b_32h(move_first_image_feature=True,
                        encode_mask=True, split_image_objects=False),
))

register_preset(Config(
    name="maxlen49_36obj_1wordCount_256_25b_32h_FocalLoss",
    caption_model="Transformer",
    model=_d256_25b_32h(xe_loss="focal", move_first_image_feature=True,
                        encode_mask=False, split_image_objects=False),
))

register_preset(Config(
    name="maxlen49_36obj_1wordCount_256_25b_32h_FocalLoss_SplitPosition",
    caption_model="Transformer",
    model=_d256_25b_32h(xe_loss="focal", split_position=True,
                        move_first_image_feature=True,
                        encode_mask=False, split_image_objects=False),
))

register_preset(Config(
    name="maxlen49_36obj_1wordCount_256_25b_32h_SplitPosition",
    caption_model="Transformer",
    model=_d256_25b_32h(split_position=True, move_first_image_feature=True,
                        encode_mask=False, split_image_objects=False),
))

register_preset(Config(
    name="maxlen49_36obj_1wordCount_256_25b_32h_move",
    caption_model="Transformer",
    model=_d256_25b_32h(move_first_image_feature=True,
                        encode_mask=False, split_image_objects=False),
))

register_preset(Config(
    name="maxlen49_36obj_1wordCount_256_66b_32h",
    caption_model="Transformer",
    model=_d256_25b_32h(encode_num_blocks=6, decode_num_blocks=6,
                        encode_mask=False, split_image_objects=False),
))

register_preset(Config(
    name="maxlen49_36obj_1wordCount_256_25b_32h_mask",
    caption_model="Transformer",
    model=_d256_25b_32h(encode_mask=True, split_image_objects=False),
))

register_preset(Config(
    name="maxlen49_36obj_1wordCount_256_25b_32h_NoBias",
    caption_model="Transformer",
    model=_d256_25b_32h(encode_mask=False, split_image_objects=False),
))

register_preset(Config(
    name="maxlen49_36obj_1wordCount_128_14b_16h_mask",
    caption_model="Transformer",
    model=_d128_14b_16h(encode_mask=True),
))

register_preset(Config(
    name="maxlen49_20obj_128_25b_32h",
    caption_model="Transformer",
    model=ModelConfig(
        num_objects=20, encode_mask=False, split_image_objects=False,
        encode_input_size=64, encode_q_k_dim=128, encode_v_dim=128,
        encode_hidden_size=128, encode_num_blocks=2, encode_num_heads=32,
        dim_word_embedding=256, decode_input_size=64, decode_q_k_dim=128,
        decode_v_dim=128, decode_hidden_size=128, decode_num_blocks=5,
        decode_num_heads=32),
))

for _name, _mask in (("maxlen49_20obj_128_14b_16h", False),
                     ("maxlen49_20obj_128_14b_16h_mask", True),
                     ("maxlen49_20obj_128_14b_16h_mask_slower", True)):
    register_preset(Config(
        name=_name, caption_model="Transformer",
        model=_d128_14b_16h(num_objects=20, encode_mask=_mask),
    ))

register_preset(Config(
    name="maxlen49_36obj_1wordCount_128_24b_8h_SplitPosition",
    caption_model="Transformer",
    model=ModelConfig(
        split_position=True, move_first_image_feature=True,
        encode_mask=False, split_image_objects=False,
        encode_input_size=64, encode_q_k_dim=128, encode_v_dim=128,
        encode_hidden_size=128, encode_num_blocks=2, encode_num_heads=8,
        dim_word_embedding=256, decode_input_size=64, decode_q_k_dim=128,
        decode_v_dim=128, decode_hidden_size=128, decode_num_blocks=4,
        decode_num_heads=8),
))

register_preset(Config(
    name="maxlen49_36obj_1wordCount_move_3",
    caption_model="Transformer",
    model=ModelConfig(
        move_first_image_feature=True, encode_mask=False,
        split_image_objects=False,
        encode_input_size=256, encode_q_k_dim=512, encode_v_dim=512,
        encode_hidden_size=1024, encode_num_blocks=3, encode_num_heads=16,
        dim_word_embedding=256, decode_input_size=256, decode_q_k_dim=512,
        decode_v_dim=512, decode_hidden_size=1024, decode_num_blocks=5,
        decode_num_heads=16),
))

register_preset(Config(
    name="maxlen49_36obj_1wordCount_1024_25b_32h_mask",
    caption_model="Transformer",
    model=ModelConfig(
        encode_mask=True, split_image_objects=False,
        encode_input_size=1024, encode_q_k_dim=1024, encode_v_dim=1024,
        encode_hidden_size=2048, encode_num_blocks=2, encode_num_heads=32,
        dim_word_embedding=1024, decode_input_size=1024,
        decode_q_k_dim=1024, decode_v_dim=1024, decode_hidden_size=2048,
        decode_num_blocks=5, decode_num_heads=32),
))

register_preset(Config(
    name="maxlen49_36obj_1wordCount_frcnn_256_25b_32h",
    caption_model="Transformer",
    model=_d256_25b_32h(dim_positions=95, encode_mask=False,
                        split_image_objects=False),
    data=DataConfig(image_model="FasterRCNN"),
))

# Tiny configs (core/config.py:553-695)
register_preset(Config(
    name="maxlen49_64",
    caption_model="Transformer",
    model=ModelConfig(
        encode_mask=False, split_image_objects=False,
        encode_input_size=64, encode_q_k_dim=64, encode_v_dim=64,
        encode_hidden_size=64, encode_num_blocks=1, encode_num_heads=2,
        dim_word_embedding=64, decode_input_size=64, decode_q_k_dim=64,
        decode_v_dim=64, decode_hidden_size=64, decode_num_blocks=3,
        decode_num_heads=2),
))

register_preset(Config(
    name="maxlen49_128",
    caption_model="Transformer",
    model=ModelConfig(
        encode_mask=False, split_image_objects=False,
        encode_input_size=64, encode_q_k_dim=128, encode_v_dim=128,
        encode_hidden_size=128, encode_num_blocks=2, encode_num_heads=4,
        dim_word_embedding=128, decode_input_size=64, decode_q_k_dim=128,
        decode_v_dim=128, decode_hidden_size=128, decode_num_blocks=4,
        decode_num_heads=4),
))

register_preset(Config(
    name="maxlen49_128_14b",
    caption_model="Transformer",
    model=ModelConfig(
        encode_mask=False, split_image_objects=False,
        encode_input_size=128, encode_q_k_dim=128, encode_v_dim=128,
        encode_hidden_size=128, encode_num_blocks=1, encode_num_heads=4,
        dim_word_embedding=128, decode_input_size=128, decode_q_k_dim=128,
        decode_v_dim=128, decode_hidden_size=128, decode_num_blocks=4,
        decode_num_heads=4),
))

register_preset(Config(
    name="maxlen49_256_13b",
    caption_model="Transformer",
    model=ModelConfig(
        encode_mask=False, split_image_objects=False,
        encode_input_size=128, encode_q_k_dim=256, encode_v_dim=256,
        encode_hidden_size=128, encode_num_blocks=1, encode_num_heads=4,
        dim_word_embedding=128, decode_input_size=128, decode_q_k_dim=256,
        decode_v_dim=256, decode_hidden_size=128, decode_num_blocks=3,
        decode_num_heads=4),
))

register_preset(Config(
    name="maxlen49_128_14b_8h",
    caption_model="Transformer",
    model=_d128_14b_16h(encode_mask=False, encode_num_heads=8,
                        decode_num_heads=8),
))

register_preset(Config(
    name="maxlen49_128_14b_16h",
    caption_model="Transformer",
    model=_d128_14b_16h(encode_mask=False),
))

# Kimi-VL-A3B-Instruct's text model (huggingface.co/moonshotai/
# Kimi-VL-A3B-Instruct, config.json) over the 37 region slots: ResNet-101
# features and YOLOv5 positions through a projector in the shape of
# Kimi-VL's, in place of MoonViT (models/lm.py)
register_preset(Config(
    name="kimi_vl_a3b_regions",
    caption_model="Transformer",
    model=ModelConfig(num_vocab=163_840, max_length=51, num_objects=36,
                      dim_features=2048, dim_positions=84,
                      architecture="mla_moe"),
    lm=LMConfig(),
))
