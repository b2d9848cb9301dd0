"""Configuration dataclasses of the PyTorch port.

The port's own copy of the SD1.5 and SDXL txt2img, IP-Adapter character and
ControlNet final-pass slices of ``theatergen_tpu/config.py``: field names
and defaults are identical, so a config written for one package reads the
same in the other.  Only the dataclasses the ported paths need live here;
the others join as their modules are ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD-style UNet2DCondition architecture; defaults are SD1.5."""

    in_channels: int = 4
    out_channels: int = 4
    sample_size: int = 64
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # levels that carry cross-attention transformers
    attention_levels: Tuple[bool, ...] = (True, True, True, False)
    # int, or one entry per level
    transformer_layers_per_block: "int | Tuple[int, ...]" = 1
    num_attention_heads: "int | Tuple[int, ...]" = 8
    cross_attention_dim: int = 768
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    norm_num_groups: int = 32
    time_embed_mult: int = 4  # time_embed_dim = block_out_channels[0] * 4
    ip_num_tokens: int = 0
    # self-attention at 1024..4096 tokens goes through the flash kernel
    flash_attention: bool = True
    quantized: bool = False
    # GroupNorms in the model dtype instead of fp32
    fast_norm: bool = True
    # in bf16: on, the whole transformer FF is one ff_matmul kernel
    # (sd15_config); off, the up-projection is a plain linear and the
    # gate + down-projection one geglu_matmul kernel (sdxl_config)
    fused_ff: bool = False
    remat: bool = False
    dtype: str = "bfloat16"

    def heads_at(self, level: int) -> int:
        h = self.num_attention_heads
        return h[level] if isinstance(h, tuple) else h

    def depth_at(self, level: int) -> int:
        d = self.transformer_layers_per_block
        return d[level] if isinstance(d, tuple) else d


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL; defaults are sd-vae-ft-mse."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP ViT-L/14 text tower (SD1.5 text encoder)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    layer_norm_eps: float = 1e-5
    act: str = "quick_gelu"
    projection_dim: int = 768
    use_text_projection: bool = False
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP vision tower; defaults are ViT-H/14 (the IP-Adapter image
    encoder), ``vit_b32()`` gives the eval encoder."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"

    @staticmethod
    def vit_b32() -> "CLIPVisionConfig":
        return CLIPVisionConfig(
            image_size=224, patch_size=32, hidden_size=768,
            intermediate_size=3072, num_layers=12, num_heads=12,
            projection_dim=512,
        )


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    """ControlNet (v1.1 lineart in the reference): a copy of the UNet's
    encoder and mid block, and the hint's conditioning embedding."""

    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    conditioning_channels: int = 3
    conditioning_embed_channels: Tuple[int, ...] = (16, 32, 96, 256)


@dataclasses.dataclass(frozen=True)
class IPAdapterConfig:
    """IP-Adapter image projection (ImageProj; MLPProj and the Resampler
    of the full and plus variants)."""

    clip_embeddings_dim: int = 1024     # CLIP ViT-H projected embed dim
    cross_attention_dim: int = 768
    num_tokens: int = 4
    resampler_depth: int = 4
    resampler_dim: int = 768
    resampler_heads: int = 12
    resampler_queries: int = 16


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    """The promptable segmenter of the character masks (the reference's
    ``models/sam.py``).  ``backend`` "lite" builds the weightless
    ``perception.sam.SAMLite`` at these widths; "hf" the checkpoint-faithful
    ``perception.sam_hf.SamHF`` (sam-vit-base, or its tiny instance where
    ``image_size <= 64``)."""

    image_size: int = 512
    patch_size: int = 16
    encoder_dim: int = 768
    encoder_layers: int = 12
    encoder_heads: int = 12
    prompt_embed_dim: int = 256
    decoder_layers: int = 2
    decoder_heads: int = 8
    num_mask_outputs: int = 3
    dtype: str = "float32"
    backend: str = "lite"


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """DDIM with SD1.5 betas."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    steps_offset: int = 1
    set_alpha_to_one: bool = False
    # "epsilon" | "v_prediction" | "sample"
    prediction_type: str = "epsilon"
    rescale_zero_terminal_snr: bool = False


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """Latent cross-attention guidance (the reference's
    ``utils/guidance.py``, ``models/pipelines.py:62-128``): ``attn_keys``
    are the layers whose maps the character pass captures and the energy
    reads; the rest weight the energy (``ops/guidance.py``) and bound its
    descent (``pipelines/guidance.py``)."""

    # (place, block_index, transformer_index, layer); the reference's
    # DEFAULT_GUIDANCE_ATTN_KEYS, models/pipelines.py:21
    attn_keys: Tuple[Tuple[str, int, int, int], ...] = (
        ("mid", 0, 0, 0), ("up", 1, 0, 0), ("up", 1, 1, 0), ("up", 1, 2, 0),
    )
    fg_top_p: float = 0.2
    bg_top_p: float = 0.2
    fg_weight: float = 1.0
    bg_weight: float = 4.0
    ref_ca_loss_weight: float = 2.0
    loss_scale: float = 30.0
    loss_threshold: float = 0.2
    max_iter: Tuple[int, ...] = (4,) * 10 + (3,) * 40   # per-step iteration cap
    guidance_steps: int = 25                            # apply in first half


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """One denoising run."""

    height: int = 512
    width: int = 512
    num_steps: int = 50
    guidance_scale: float = 7.5
    frozen_step_ratio: float = 0.5
    fg_blending_ratio: float = 0.1
    ip_scale_hit: float = 0.4
    ip_scale_final: float = 0.1
    fast_after_steps: Optional[int] = None
    fast_rate: int = 2
    cfg_cutoff_fraction: Optional[float] = None
    deepcache_interval: Optional[int] = None
    controlnet_interval: Optional[int] = None
    max_objects: int = 8
    vae_scale: int = 8
    scheduler_type: str = "ddim"

    @property
    def latent_height(self) -> int:
        return self.height // self.vae_scale

    @property
    def latent_width(self) -> int:
        return self.width // self.vae_scale


@dataclasses.dataclass(frozen=True)
class TheaterConfig:
    """Top-level bundle of the configs the ported paths read."""

    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    text: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)
    # SDXL's second text tower (OpenCLIP bigG); None for SD1.5
    text2: Optional[CLIPTextConfig] = None
    vision: CLIPVisionConfig = dataclasses.field(
        default_factory=CLIPVisionConfig)
    controlnet: ControlNetConfig = dataclasses.field(
        default_factory=ControlNetConfig)
    ip_adapter: IPAdapterConfig = dataclasses.field(
        default_factory=IPAdapterConfig)
    sam: SAMConfig = dataclasses.field(default_factory=SAMConfig)
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    guidance: GuidanceConfig = dataclasses.field(
        default_factory=GuidanceConfig)
    pipeline: PipelineConfig = dataclasses.field(
        default_factory=PipelineConfig)


def tiny_config(latent_size: int = 8) -> TheaterConfig:
    """A miniature config for CPU tests: same topology, tiny widths."""
    unet = UNetConfig(
        sample_size=latent_size,
        block_out_channels=(32, 64, 64),
        layers_per_block=1,
        attention_levels=(True, True, False),
        num_attention_heads=2,
        cross_attention_dim=32,
        norm_num_groups=8,
        dtype="float32",
        flash_attention=False,
    )
    vae = VAEConfig(
        block_out_channels=(16, 32),
        layers_per_block=1,
        norm_num_groups=8,
        dtype="float32",
    )
    text = CLIPTextConfig(
        vocab_size=1024, hidden_size=32, intermediate_size=64,
        num_layers=2, num_heads=2, max_length=16, projection_dim=32,
    )
    vision = CLIPVisionConfig(
        image_size=32, patch_size=16, hidden_size=32, intermediate_size=64,
        num_layers=2, num_heads=2, projection_dim=32,
    )
    ip = IPAdapterConfig(
        clip_embeddings_dim=32, cross_attention_dim=32, num_tokens=4,
        resampler_depth=1, resampler_dim=32, resampler_heads=2,
        resampler_queries=4,
    )
    sam = SAMConfig(
        image_size=64, patch_size=16, encoder_dim=32, encoder_layers=2,
        encoder_heads=2, prompt_embed_dim=32, decoder_layers=1,
        decoder_heads=2,
    )
    pipe = PipelineConfig(
        height=latent_size * 2, width=latent_size * 2, num_steps=4,
        max_objects=3, vae_scale=2,
    )
    guidance = GuidanceConfig(
        # tiny UNet has layers_per_block=1 → up blocks carry 2 attentions
        attn_keys=(("mid", 0, 0, 0), ("up", 1, 0, 0), ("up", 1, 1, 0)),
        max_iter=(2, 2, 2, 2),
        guidance_steps=2,
    )
    return TheaterConfig(
        unet=unet, vae=vae, text=text, vision=vision,
        # one stride-2 stage to match the tiny VAE's scale-2 latents
        controlnet=ControlNetConfig(unet=unet,
                                    conditioning_embed_channels=(8, 16)),
        ip_adapter=ip, sam=sam, pipeline=pipe, guidance=guidance)


def sd15_config() -> TheaterConfig:
    """Full-size SD1.5 stack (the main path), with the fused FF on; the
    ControlNet encoder shares the UNet config, the flag included.  A 768-px
    canvas is ``dataclasses.replace`` of ``pipeline.height``/``width``: the
    modules do not depend on it."""
    base = TheaterConfig()
    unet = dataclasses.replace(base.unet, fused_ff=True)
    return dataclasses.replace(
        base, unet=unet,
        controlnet=dataclasses.replace(base.controlnet, unet=unet))


def tiny_xl_config(latent_size: int = 8) -> TheaterConfig:
    """Miniature SDXL-shaped config: per-level depths/heads, text_time
    micro-conditioning, dual text towers, EulerAncestral, the IP-Adapter
    projecting to the two towers' width, guidance keys on the 2-level
    UNet, and a ControlNet on the XL UNet."""
    base = tiny_config(latent_size)
    text2 = dataclasses.replace(
        base.text, hidden_size=48, num_heads=2, intermediate_size=96,
        act="gelu", projection_dim=32, use_text_projection=True,
    )
    ctx_dim = base.text.hidden_size + 48   # concat of both towers
    unet = dataclasses.replace(
        base.unet,
        block_out_channels=(32, 64),
        attention_levels=(False, True),
        transformer_layers_per_block=(0, 2),
        num_attention_heads=(2, 4),
        cross_attention_dim=ctx_dim,
        addition_embed_type="text_time",
        addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=32 + 6 * 8,
    )
    ip = dataclasses.replace(base.ip_adapter, cross_attention_dim=ctx_dim)
    pipe = dataclasses.replace(base.pipeline,
                               scheduler_type="euler_ancestral")
    # 2-level UNet: attention lives at level 1, so in up_blocks 0
    guidance = dataclasses.replace(
        base.guidance,
        attn_keys=(("mid", 0, 0, 0), ("up", 0, 0, 0), ("up", 0, 1, 0)))
    return dataclasses.replace(
        base, unet=unet, text2=text2, pipeline=pipe, ip_adapter=ip,
        guidance=guidance,
        controlnet=ControlNetConfig(unet=unet,
                                    conditioning_embed_channels=(8, 16)))


def sdxl_config() -> TheaterConfig:
    """SDXL base stack: 1024×1024, EulerAncestral 30 steps, two text
    towers, ``text_time`` micro-conditioning, head dim 64 at every level,
    and the split FF (``fused_ff=False``: GEGLU up-projection, then the
    ``geglu_matmul`` kernel), and the IP-Adapter XL projecting to the
    2048-wide context.  The default ControlNet and guidance keys are the
    JAX twin's too: the XL turn conditions its final pass on the
    T2I-Adapter, and the guidance keys name layers the XL UNet has."""
    unet = UNetConfig(
        sample_size=128,
        block_out_channels=(320, 640, 1280),
        layers_per_block=2,
        attention_levels=(False, True, True),
        transformer_layers_per_block=(0, 2, 10),
        num_attention_heads=(5, 10, 20),   # head_dim 64 at every level
        cross_attention_dim=2048,
        addition_embed_type="text_time",
        projection_class_embeddings_input_dim=2816,
        fused_ff=False,
    )
    # text encoder 2 (OpenCLIP bigG): hidden 1280, 32 layers, gelu
    text2 = CLIPTextConfig(
        hidden_size=1280, intermediate_size=5120, num_layers=32,
        num_heads=20, act="gelu", projection_dim=1280,
        use_text_projection=True,
    )
    pipe = PipelineConfig(
        height=1024, width=1024, num_steps=30,
        scheduler_type="euler_ancestral",
    )
    ip = IPAdapterConfig(cross_attention_dim=2048)
    return TheaterConfig(unet=unet, text2=text2, pipeline=pipe, ip_adapter=ip)
