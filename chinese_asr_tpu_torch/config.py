"""Frozen, typed configuration (a copy of ``chinese_asr_tpu/config.py``,
kept here so the PyTorch package never imports the JAX one).

The reference keeps one mutable global dict (``gpd``, reference gpd.py:4-133)
that every module star-imports and partially reads at import time.  That design
cannot work under ``jax.jit`` (configs must be static, hashable trace-time
constants), so here the whole configuration is a tree of frozen dataclasses
resolved exactly once.  Field names and defaults mirror the *used subset* of
the reference dict, including the keys injected at runtime by reference
main.py:122-125.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class AudioConfig:
    """Front-end parameters (reference gpd.py:8-21)."""

    sample_rate: int = 16000
    window_len: float = 0.025      # seconds -> win_length 400
    window_step: float = 0.01      # seconds -> hop 160
    n_fft: int = 512
    n_mels: int = 80
    f_min: float = 80.0
    f_max: float = 7600.0
    dither: float = 1.0 / 32767.0  # train-only Gaussian dither (gpd.py:15)
    preemphasis: float = 0.97
    delta_delta: bool = True       # 3-channel delta / delta-delta
    downsample: bool = True        # x3 frame stacking
    normalize: bool = True         # per-utterance instance norm

    @property
    def win_length(self) -> int:
        return int(self.sample_rate * self.window_len)

    @property
    def hop_length(self) -> int:
        return int(self.sample_rate * self.window_step)

    @property
    def feat_dim(self) -> int:
        """Model input dim: 80 * 3 (delta) * 3 (stack) = 720 (encoder.py:19)."""
        d = self.n_mels
        if self.delta_delta:
            d *= 3
        if self.downsample:
            d *= 3
        return d


@dataclass(frozen=True)
class AugmentConfig:
    """Waveform augmentation (reference gpd.py:23-36, data.py:283-343)."""

    aug_prob: float = 0.0
    volume_gain_min: float = -10.0
    volume_gain_max: float = 10.0
    speed_rate_min: float = 0.95
    speed_rate_max: float = 1.05
    shift_ms_min: float = -5.0
    shift_ms_max: float = 5.0


@dataclass(frozen=True)
class VocabConfig:
    """Special ids + size (reference gpd.py:39-47, decoder.py:11-12)."""

    pad: int = 0
    sos: int = 1
    eos: int = 2
    unk: int = 3
    max_num_words: int = 5000

    @property
    def vocab_size(self) -> int:
        return self.max_num_words + 4


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder family selector + hyperparameters (reference gpd.py:56-77)."""

    encoder_type: str = "LSTM"     # CNN1D, CNN2D, LSTM, GRU, RNN_TANH, RNN_RELU,
                                   # SELF_ATTENTION, SELF_LOCAL_ATTENTION, CNN1D_RNN,
                                   # CNN1D_SELF_ATTENTION, CRNN
    hidden_size: int = 256
    num_layers: int = 4
    residual: bool = True
    bidirectional: bool = True
    skip_step: int = 0
    # conv-family parameters
    norm: str = "BN"               # BN, LN, IN, NONE
    ks: int = 3
    stride: Tuple[int, ...] = (2, 2, 2, 1, 1)
    act: str = "RELU"              # GLU, RELU, SIGMOID, TANH
    # self-attention-family parameters
    mha_proj: bool = True
    ws: int = 11                   # local-attention window
    ffn_size: int = 256
    self_attn_heads: int = 4
    # CRNN / DCNN family
    conv_channels: int = 32
    dcnn_middle: int = 4

    @property
    def num_directions(self) -> int:
        return 2 if self.bidirectional else 1

    @property
    def enc_size(self) -> int:
        if self.encoder_type in ("LSTM", "GRU", "RNN_TANH", "RNN_RELU"):
            return self.hidden_size * self.num_directions
        return self.hidden_size


@dataclass(frozen=True)
class AttentionConfig:
    """Bahdanau attention (reference gpd.py:88-93, attention.py:20-111)."""

    attn_type: str = "B"           # B (Bahdanau) or L (Luong)
    attn_size: int = 128
    map_enc: bool = False
    attn_hidden_size: int = 640    # only for attn_type == 'L'
    heads: int = 1
    linear_map: bool = False


@dataclass(frozen=True)
class DecoderConfig:
    """Decoder (reference gpd.py:79-86, decoder.py:10-137)."""

    decoder_type: str = "LSTM"
    hidden_size: int = 512
    num_layers: int = 1
    embed_dim: int = 256
    temperature: float = 1.0
    input_feeding: bool = True
    init_cell_state_as_param: bool = False


@dataclass(frozen=True)
class DecodeConfig:
    """Decode / scoring (reference gpd.py:114-127)."""

    max_len: int = 40
    beam_width: int = 4
    lm_path: Optional[str] = None
    second_pass: bool = True
    lm_weight: float = 1.5         # main.py:49
    length_weight: float = 1.5     # main.py:50


@dataclass(frozen=True)
class TrainConfig:
    """Training loop (reference gpd.py:96-132, model.py:84-345)."""

    batch_size: int = 256
    epochs: int = 50
    optimizer: str = "ADAM"        # ADAM, SGD, ADABOUND, ADABOUNDW
    base_lr: float = 1e-3
    momentum: float = 0.9
    min_lr: float = 1e-5
    clip: float = 0.0
    l2_decay: float = 1e-5
    ramp_up_iters: int = 0
    label_smooth: float = 0.1
    ss: float = 0.0                # scheduled-sampling probability
    # eval / LR plateau
    eval_batch_size: int = 256
    num_eval_steps: int = -1       # -1 => one epoch
    patience: int = 4
    dec_rate_threshold: float = 0.0
    factor: float = 0.5
    shuffle_updates: int = 10      # bucketing buffer = shuffle_updates * bsz
    # misc
    fine_tune: bool = False
    save_dir: str = "./ckpt"
    continue_train_ckpt_path: Optional[str] = None
    seed: int = 0
    # mixed precision: forward/backward compute dtype ("float32" or
    # "bfloat16").  Master weights, optimizer state, BN running stats and
    # the CE loss stay float32 either way (no reference counterpart — the
    # reference trains f32 on GPU; on TPU bf16 doubles MXU throughput)
    compute_dtype: str = "float32"
    # rematerialize the decoder scan body in the backward pass
    # (jax.checkpoint): trades ~1 extra decoder forward for dropping the
    # per-step attention/gate residuals — headroom for large batch x long
    # utterances on a 16 GB chip (no reference counterpart)
    remat: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for pjit/shard_map (no reference counterpart; the
    reference is single-device, SURVEY.md section 2.c)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1        # -1 => all devices on the data axis
    model_parallel: int = 1        # vocab-dim sharding of projection/embedding


@dataclass(frozen=True)
class Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    vocab: VocabConfig = field(default_factory=VocabConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    verbose: bool = True

    # ---- convenience -----------------------------------------------------
    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)

    def with_(self, section: str, **kwargs) -> "Config":
        """Return a new Config with ``section`` fields replaced."""
        cur = getattr(self, section)
        return dataclasses.replace(self, **{section: dataclasses.replace(cur, **kwargs)})

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(s: str) -> "Config":
        raw = json.loads(s)

        def build(cls, d):
            kw = {}
            for f in dataclasses.fields(cls):
                if f.name in d:
                    v = d[f.name]
                    if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
                        v = build(f.type, v)
                    elif isinstance(v, list):
                        v = tuple(v)
                    kw[f.name] = v
            return cls(**kw)

        sections = dict(
            audio=AudioConfig, augment=AugmentConfig, vocab=VocabConfig,
            encoder=EncoderConfig, attention=AttentionConfig, decoder=DecoderConfig,
            decode=DecodeConfig, train=TrainConfig, mesh=MeshConfig,
        )
        kw = {}
        for name, cls in sections.items():
            if name in raw:
                d = dict(raw[name])
                for f in dataclasses.fields(cls):
                    if f.name in d and isinstance(d[f.name], list):
                        d[f.name] = tuple(d[f.name])
                kw[name] = cls(**{k: v for k, v in d.items()
                                  if k in {f.name for f in dataclasses.fields(cls)}})
        if "verbose" in raw:
            kw["verbose"] = raw["verbose"]
        return Config(**kw)


DEFAULT_CONFIG = Config()
