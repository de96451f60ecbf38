"""Configuration dataclasses of the port: the dataclasses of
``mimo_tpu/config.py`` without ``jax.numpy`` (that module cannot be imported
where there is no JAX). Fields and defaults are held equal to the original,
field for field, by ``tests/test_torch_context.py``.

The dtype policy uses torch dtypes: bf16 params and compute on CUDA, fp32
for the CPU tests (``DTypePolicy.for_device``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch


@dataclass(frozen=True)
class DTypePolicy:
    """Params/compute dtype policy; norms and softmax statistics accumulate
    in fp32 inside the layer functions regardless."""

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16

    @staticmethod
    def bf16() -> "DTypePolicy":
        return DTypePolicy(param_dtype=torch.bfloat16,
                           compute_dtype=torch.bfloat16)

    @staticmethod
    def fp32() -> "DTypePolicy":
        return DTypePolicy(param_dtype=torch.float32,
                           compute_dtype=torch.float32)

    @staticmethod
    def for_device(device: torch.device) -> "DTypePolicy":
        """bf16 on CUDA, fp32 elsewhere."""
        return (DTypePolicy.bf16() if torch.device(device).type == "cuda"
                else DTypePolicy.fp32())


@dataclass(frozen=True)
class MotionModuleConfig:
    """AnimateDiff 'Vanilla' temporal transformer."""

    num_heads: int = 8
    num_transformer_blocks: int = 1
    attentions_per_block: int = 2
    position_encoding_max_len: int = 32
    norm_num_groups: int = 32
    zero_initialize: bool = True


@dataclass(frozen=True)
class UNetConfig:
    """SD1.5 UNet topology, shared by the 2D reference UNet and the 3D
    denoising UNet."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    cross_attn_blocks: Tuple[bool, ...] = (True, True, True, False)
    layers_per_block: int = 2
    num_heads: int = 8
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    use_motion_module: bool = False
    motion_module_mid_block: bool = True
    motion: MotionModuleConfig = field(default_factory=MotionModuleConfig)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def num_blocks(self) -> int:
        return len(self.block_out_channels)

    def head_dim(self, channels: int) -> int:
        return channels // self.num_heads


def sd15_reference_unet_config() -> UNetConfig:
    return UNetConfig(in_channels=4, use_motion_module=False)


def sd15_denoising_unet_config() -> UNetConfig:
    return UNetConfig(in_channels=8, use_motion_module=True)


@dataclass(frozen=True)
class PoseGuiderConfig:
    conditioning_channels: int = 3
    block_out_channels: Tuple[int, ...] = (16, 32, 96, 256)
    embedding_channels: int = 320


@dataclass(frozen=True)
class VAEConfig:
    """sd-vae-ft-mse AutoencoderKL."""

    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    sample_channels: int = 3

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


@dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT-L/14 vision tower + projection."""

    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 224
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5


@dataclass(frozen=True)
class SchedulerConfig:
    """DDIM with v-prediction + zero-SNR rescale + trailing spacing."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "v_prediction"
    rescale_betas_zero_snr: bool = True
    timestep_spacing: str = "trailing"
    steps_offset: int = 1
    clip_sample: bool = False
    eta: float = 0.0


@dataclass(frozen=True)
class PipelineConfig:
    width: int = 784
    height: int = 784
    num_inference_steps: int = 25
    guidance_scale: float = 3.5
    seed: int = 42
    context_frames: int = 24
    context_stride: int = 1
    context_overlap: int = 4
    max_frames: int = 150
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)


@dataclass(frozen=True)
class MIMOConfig:
    """Top-level model bundle."""

    reference_unet: UNetConfig = field(default_factory=sd15_reference_unet_config)
    denoising_unet: UNetConfig = field(default_factory=sd15_denoising_unet_config)
    pose_guider: PoseGuiderConfig = field(default_factory=PoseGuiderConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    clip_vision: CLIPVisionConfig = field(default_factory=CLIPVisionConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)


# ---------------------------------------------------------------------------
# tiny configs for tests / dry runs
# ---------------------------------------------------------------------------


def tiny_unet_config(in_channels: int = 4,
                     use_motion_module: bool = False) -> UNetConfig:
    return UNetConfig(
        in_channels=in_channels,
        out_channels=4,
        block_out_channels=(32, 64, 64, 64),
        cross_attn_blocks=(True, True, True, False),
        layers_per_block=1,
        num_heads=4,
        cross_attention_dim=48,
        norm_num_groups=8,
        use_motion_module=use_motion_module,
        motion=MotionModuleConfig(
            num_heads=4, num_transformer_blocks=1, attentions_per_block=2,
            position_encoding_max_len=32, norm_num_groups=8),
    )


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                     norm_num_groups=8)


def tiny_clip_config() -> CLIPVisionConfig:
    return CLIPVisionConfig(hidden_size=32, num_layers=2, num_heads=4,
                            patch_size=16, image_size=32, projection_dim=48)


def tiny_mimo_config(frames: int = 8, size: int = 64) -> MIMOConfig:
    return MIMOConfig(
        reference_unet=tiny_unet_config(4, False),
        denoising_unet=tiny_unet_config(8, True),
        pose_guider=PoseGuiderConfig(block_out_channels=(8, 8, 16, 16),
                                     embedding_channels=32),
        vae=tiny_vae_config(),
        clip_vision=tiny_clip_config(),
        pipeline=PipelineConfig(width=size, height=size, num_inference_steps=3,
                                guidance_scale=3.5, context_frames=4,
                                context_overlap=1),
    )


# ---------------------------------------------------------------------------
# (de)serialization
# ---------------------------------------------------------------------------


def to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def save_json(cfg: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2, default=str)


def _build(cls, data: Dict[str, Any]):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        kwargs[f.name] = tuple(v) if isinstance(v, list) else v
    return cls(**kwargs)


def load_json(path: str) -> MIMOConfig:
    with open(path) as f:
        data = json.load(f)

    def unet(d):
        d = dict(d)
        motion = d.pop("motion", None)
        cfg = _build(UNetConfig, d)
        if motion:
            cfg = dataclasses.replace(cfg,
                                      motion=_build(MotionModuleConfig, motion))
        return cfg

    def pipeline(d):
        d = dict(d)
        sched = d.pop("scheduler", None)
        cfg = _build(PipelineConfig, d)
        if sched:
            cfg = dataclasses.replace(cfg,
                                      scheduler=_build(SchedulerConfig, sched))
        return cfg

    return MIMOConfig(
        reference_unet=unet(data.get("reference_unet", {})),
        denoising_unet=unet(data.get("denoising_unet", {})),
        pose_guider=_build(PoseGuiderConfig, data.get("pose_guider", {})),
        vae=_build(VAEConfig, data.get("vae", {})),
        clip_vision=_build(CLIPVisionConfig, data.get("clip_vision", {})),
        pipeline=pipeline(data.get("pipeline", {})),
    )
