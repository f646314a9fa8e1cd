"""Configuration dataclasses for the PyTorch port of the FlexAM stack.

A copy of `flexam_tpu/config.py`: the port keeps its own, so that it
imports nothing of the JAX package.

One typed config tree replaces the reference's three config layers (argparse +
OmegaConf YAML + ComfyUI INPUT_TYPES schemas; see reference
`config/wan2.2/wan_civitai_5b_FlexAM.yaml` and `FlexAM/utils/utils.py:17-21`
`filter_kwargs` signature-filtering magic).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class DiTConfig:
    """Wan2.2 FlexAM DiT hyperparameters.

    Mirrors reference `FlexAM/models/wan_transformer3d_FlexAM.py:537-566`
    (`WanTransformer3DModel_FlexAM.__init__`), with the YAML `dict_mapping`
    renames (`in_dim <- in_channels`, `dim <- hidden_size`) already applied.
    """

    model_type: str = "t2v"
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 148          # x(48) + control(48) + mask(4) + masked video(48)
    dim: int = 3072
    ffn_dim: int = 14336
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 48
    num_heads: int = 24
    num_layers: int = 30
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6
    cross_attn_type: str = "t2v_cross_attn"
    # FlexAM additions (`wan_civitai_5b_FlexAM.yaml:9-12`)
    add_ref_conv: bool = True
    in_dim_ref_conv: int = 48
    add_cnn_block: bool = True
    in_dim_cnn_block: int = 288   # control 48 + depth 48 + 4x cos 192
    out_dim_cnn_block: int = 48
    # Inner widths/groups of the 5-conv control-fusion CNN (hardcoded 192/96 and
    # GroupNorm(24,.)/GroupNorm(12,.) in the reference,
    # `wan_transformer3d_FlexAM.py:680-705`); configurable here for tiny tests.
    cnn_block_dims: Tuple[int, int] = (192, 96)
    cnn_block_groups: Tuple[int, int] = (24, 12)
    add_control_adapter: bool = False
    in_dim_control_adapter: int = 24
    downscale_factor_control_adapter: int = 8
    # RoPE table length (`wan_transformer3d_FlexAM.py:658-665`)
    rope_max_seq: int = 1024

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    def __post_init__(self):
        assert self.dim % self.num_heads == 0
        assert (self.dim // self.num_heads) % 2 == 0


@dataclass(frozen=True)
class VAEConfig:
    """Wan2.2 3.8 causal video VAE (`FlexAM/models/wan_vae3_8.py:892-904`).

    16x spatial (2x pixel patchify + 3 conv downs), 4x temporal, 48 latent ch.
    """

    latent_channels: int = 48
    c_dim: int = 160            # encoder base width
    dec_dim: int = 256          # decoder base width
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    temporal_compression_ratio: int = 4
    spatial_compression_ratio: int = 16
    dropout: float = 0.0


@dataclass(frozen=True)
class T5Config:
    """umT5-XXL encoder (`config/wan2.2/wan_civitai_5b_FlexAM.yaml:20-32`)."""

    vocab: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    max_distance: int = 128
    shared_pos: bool = False
    dropout: float = 0.0
    text_length: int = 512


@dataclass(frozen=True)
class SchedulerConfig:
    """Flow-matching scheduler (`wan_civitai_5b_FlexAM.yaml:34-42`)."""

    scheduler_type: str = "flow_match_euler"  # flow_match_euler|flow_unipc|flow_dpm
    num_train_timesteps: int = 1000
    shift: float = 5.0
    use_dynamic_shifting: bool = False
    solver_order: int = 2


@dataclass(frozen=True)
class FlexAMConfig:
    """Top-level model wiring (equivalent of wan_civitai_5b_FlexAM.yaml)."""

    dit: DiTConfig = field(default_factory=DiTConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    t5: T5Config = field(default_factory=T5Config)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    # Timestep-MoE: optional second (high-noise) transformer selected when
    # t >= boundary*num_train_timesteps (`pipeline...FlexAM.py:903-909`).
    transformer_combination_type: str = "single"  # "single" | "moe"
    boundary: float = 0.875

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_reference_yaml(cls, path: str) -> "FlexAMConfig":
        """Load a reference-format model YAML (the OmegaConf files under
        `config/wan2.2/`, e.g. `wan_civitai_5b_FlexAM.yaml`) so existing
        configs work unchanged. Applies the `dict_mapping` renames
        (`in_dim <- in_channels`, `dim <- hidden_size`) the reference does
        at load time (`wan_transformer3d_FlexAM.py:1210-1225`)."""
        import yaml

        with open(path) as f:
            y = yaml.safe_load(f)
        tkw = dict(y.get("transformer_additional_kwargs", {}))
        mapping = tkw.pop("dict_mapping", {}) or {}
        renames = {v: k for k, v in mapping.items()}   # ckpt-name -> ours
        dit_fields = {f.name for f in dataclasses.fields(DiTConfig)}
        dit_kwargs = {}
        for k, v in tkw.items():
            k = renames.get(k, k)
            if k in dit_fields:
                dit_kwargs[k] = tuple(v) if isinstance(v, list) else v
        vkw = y.get("vae_kwargs", {})
        vae_fields = {f.name for f in dataclasses.fields(VAEConfig)}
        vae_kwargs = {}
        for k, v in vkw.items():
            if k in vae_fields:
                vae_kwargs[k] = tuple(v) if isinstance(v, list) else v
        tekw = y.get("text_encoder_kwargs", {})
        t5_fields = {f.name for f in dataclasses.fields(T5Config)}
        t5_kwargs = {k: v for k, v in tekw.items() if k in t5_fields}
        if "text_length" in tekw:
            t5_kwargs["text_length"] = tekw["text_length"]
        skw = y.get("scheduler_kwargs", {})
        sch_fields = {f.name for f in dataclasses.fields(SchedulerConfig)}
        sch_kwargs = {k: v for k, v in skw.items() if k in sch_fields}
        return cls(
            dit=DiTConfig(**dit_kwargs),
            vae=VAEConfig(**vae_kwargs),
            t5=T5Config(**t5_kwargs),
            scheduler=SchedulerConfig(**sch_kwargs),
            transformer_combination_type=tkw.get(
                "transformer_combination_type", "single"),
            boundary=tkw.get("boundary", 0.875),
        )

    def to_reference_yaml(self, path: str) -> None:
        """Write this config in the reference YAML schema (the inverse
        of `from_reference_yaml`, using OUR field names directly — no
        dict_mapping needed). Used to generate the configs bundled under
        `flexam_tpu/configs/` so the framework is self-contained."""
        import yaml

        def _plain(dc):
            return {k: (list(v) if isinstance(v, tuple) else v)
                    for k, v in dataclasses.asdict(dc).items()}

        doc = {
            "format": "civitai",
            "pipeline": "Wan",
            "transformer_additional_kwargs": {
                **_plain(self.dit),
                "transformer_combination_type":
                    self.transformer_combination_type,
                "boundary": self.boundary,
            },
            "vae_kwargs": _plain(self.vae),
            "text_encoder_kwargs": _plain(self.t5),
            "scheduler_kwargs": _plain(self.scheduler),
        }
        with open(path, "w") as f:
            f.write("# generated by FlexAMConfig.to_reference_yaml — the\n"
                    "# framework's bundled model hyperparameters, readable\n"
                    "# by from_reference_yaml (reference-schema layout)\n")
            yaml.safe_dump(doc, f, sort_keys=False)

    @classmethod
    def from_json(cls, s: str) -> "FlexAMConfig":
        d = json.loads(s)
        return cls(
            dit=DiTConfig(**{**d["dit"], "patch_size": tuple(d["dit"]["patch_size"])}),
            vae=VAEConfig(**{
                **d["vae"],
                "dim_mult": tuple(d["vae"]["dim_mult"]),
                "temporal_downsample": tuple(d["vae"]["temporal_downsample"]),
            }),
            t5=T5Config(**d["t5"]),
            scheduler=SchedulerConfig(**d["scheduler"]),
            transformer_combination_type=d.get("transformer_combination_type", "single"),
            boundary=d.get("boundary", 0.875),
        )


# The flagship preset: Wan2.2-Fun-5B-FLEXAM.
WAN22_5B_FLEXAM = FlexAMConfig()

# Base Wan2.2-TI2V-5B (no FlexAM additions — the `wan_transformer3d.py`
# model kept for ComfyUI "Fun" workflows; diff per SURVEY.md §2.1 is
# exactly: density embeds, modulation_density, cnn blocks, ref conv).
WAN22_5B_BASE = FlexAMConfig(
    dit=DiTConfig(in_dim=100, add_ref_conv=False, add_cnn_block=False))

# Wan2.1-Fun 1.3B geometry (`cache_utils.py` coefficient family;
# dim 1536, 30 layers, 12 heads; Wan2.1 VAE: 8x spatial, 16 ch).
WAN21_FUN_1_3B = FlexAMConfig(
    dit=DiTConfig(dim=1536, ffn_dim=8960, num_heads=12, num_layers=30,
                  in_dim=48, out_dim=16, add_ref_conv=False,
                  add_cnn_block=False),
    vae=VAEConfig(latent_channels=16, c_dim=96, dec_dim=96,
                  spatial_compression_ratio=8),
)

# Wan2.1-Fun 14B geometry (dim 5120, 40 layers, 40 heads).
WAN21_FUN_14B = FlexAMConfig(
    dit=DiTConfig(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40,
                  in_dim=48, out_dim=16, add_ref_conv=False,
                  add_cnn_block=False),
    vae=VAEConfig(latent_channels=16, c_dim=96, dec_dim=96,
                  spatial_compression_ratio=8),
)


def tiny_test_config() -> FlexAMConfig:
    """A tiny config for CPU tests (BASELINE.json config 1 scale)."""
    return FlexAMConfig(
        dit=DiTConfig(
            dim=96,
            ffn_dim=256,
            num_heads=4,
            num_layers=2,
            in_dim=28,          # x(8) + control(8) + mask(4) + masked(8)
            out_dim=8,
            in_dim_ref_conv=8,
            in_dim_cnn_block=48,  # control 8 + depth 8 + 4x cos 32
            out_dim_cnn_block=8,
            cnn_block_dims=(16, 8),
            cnn_block_groups=(4, 2),
            text_dim=64,
            freq_dim=32,
            text_len=16,
            rope_max_seq=64,
        ),
        vae=VAEConfig(
            latent_channels=8,
            c_dim=16,
            dec_dim=16,
            dim_mult=(1, 2, 4, 4),
            num_res_blocks=1,
        ),
        t5=T5Config(
            vocab=256, dim=64, dim_attn=64, dim_ffn=128, num_heads=4,
            num_layers=2, num_buckets=32, shared_pos=False, text_length=16,
        ),
    )
