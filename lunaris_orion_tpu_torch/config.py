"""Typed configuration for models, training and data.

The port's own copy of the JAX package's `config.py`: the same three frozen
dataclasses with the same fields, defaults and derived properties, so that a
reference checkpoint's `args` snapshot and a JAX-side config convert to and
from these without loss (`tests/test_torch_config.py` holds the two copies
field by field). Fields that steer parts of the JAX package the port has not
taken over (mesh axes, dispatch and planner knobs) are kept for that round
trip; the port's functions read configs by attribute only.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class VAEConfig:
    """LunarisCoreVAE architecture (reference: lunar_generate.py:84-291).

    The reference hard-codes 128x128 inputs and the 64/128/256/512 channel
    ladder; here both are configurable (small settings are used for CPU tests
    and the multi-chip dry run) with reference defaults.
    """

    latent_dim: int = 256
    image_size: int = 128
    base_channels: int = 64
    channel_mults: Tuple[int, ...] = (1, 2, 4, 8)
    gn_groups: int = 8

    @property
    def num_down(self) -> int:
        return len(self.channel_mults)

    @property
    def channels(self) -> Tuple[int, ...]:
        return tuple(self.base_channels * m for m in self.channel_mults)

    @property
    def bottleneck_hw(self) -> int:
        hw = self.image_size
        for _ in self.channel_mults:
            hw //= 2
        return hw

    @property
    def bottleneck_dim(self) -> int:
        """Flattened bottleneck size (reference 512*8*8=32768, lunar_generate.py:124)."""
        return self.channels[-1] * self.bottleneck_hw * self.bottleneck_hw


@dataclass(frozen=True)
class TeacherConfig:
    """LunarMoETeacher architecture (reference: lunar_evaluator.py:291-336).

    `extractor_dim` is the feature-extractor output width: the reference
    hard-codes it to 128 regardless of `feature_dim`
    (lunar_evaluator.py:313,340,357), so expert blocks map
    extractor_dim -> feature_dim.
    """

    num_experts: int = 4
    feature_dim: int = 128
    extractor_dim: int = 128
    extractor_stem: int = 32
    branch_dim: int = 64
    dropout_rate: float = 0.1
    rel_pos_size: int = 8
    expert_layers: int = 3
    intermediate_dim: int = 256
    embedding_dim: int = 64
    num_heads: int = 8
    layer_scale_init: float = 0.1
    image_size: int = 128
    attn_window: Optional[int] = None  # tokens attend only within windows of this size
                                       # on the flattened token axis (None = global)

    @property
    def head_dim(self) -> int:
        assert self.feature_dim % self.num_heads == 0
        return self.feature_dim // self.num_heads


@dataclass(frozen=True)
class TrainConfig:
    """Full training-run configuration.

    Field-for-field superset of the reference argparse surface
    (train_hybrid.py:1076-1133); the JAX package's extensions are grouped
    at the end.
    """

    # --- data ---
    data_dir: str = ""
    output_dir: str = "output"
    resume_from: Optional[str] = None

    # --- training ---
    batch_size: int = 16
    gradient_accumulation_steps: int = 2
    chunk_size: int = 32  # parsed-for-compat
    num_epochs: int = 100
    num_workers: int = 4  # parsed-for-compat
    seed: int = 42
    compile: bool = False  # parsed-for-compat
    mixed_precision: bool = False  # bf16 activations, f32 parameters and optimizer

    # --- model ---
    latent_dim: int = 256
    embedding_dim: int = 64
    feature_dim: int = 128
    num_experts: int = 4

    # --- optimizer ---
    vae_lr: float = 1e-4
    teacher_lr: float = 1e-4
    min_lr: float = 1e-6
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    scheduler_t0: int = 10

    # --- loss weights ---
    recon_weight: float = 1.0
    kl_weight: float = 0.1
    quality_weight: float = 0.5

    # --- logging / checkpoints ---
    log_every: int = 100
    save_every: int = 1000
    sample_every: int = 500
    keep_n_checkpoints: int = 5
    early_stopping_patience: int = 7
    eval_save_freq: int = 500

    # --- RL ---
    reward_scale: float = 0.1
    semantic_weight: float = 0.5
    baseline_momentum: float = 0.9

    # --- device ---
    force_cpu: bool = False
    memory_efficient: bool = False  # parsed-for-compat (no-op in the reference too)

    # --- extensions of the JAX package (not in the reference) ---
    image_size: int = 128
    data_axis: str = "data"
    model_axis: str = "model"
    mesh_shape: Optional[Tuple[int, ...]] = None  # None -> (n_devices, 1)
    use_pallas: Optional[bool] = None  # JAX package: Pallas dispatch
    attn_impl: str = "auto"     # JAX package: attention dispatch ('auto', 'full',
                                # 'flash', 'pallas', 'ring', 'allgather')
    attn_window: int = 0        # >0: teacher attention within windows of this many
                                # tokens (not ported yet: the port raises)
    val_fraction: float = 0.1
    prefetch_depth: int = 2
    donate_state: bool = True
    profile_steps: int = 0      # JAX package: profiler trace of n steps
    debug_nans: bool = False    # JAX package: nan checking
    remat: Optional[bool] = None  # None: a planner may pick no-remat when it fits
    fast_rng: bool = True       # JAX package: PRNG implementation
    bf16_momentum: bool = False  # bf16 Adam first moments (not ported: raises)
    steps_per_call: int = 1     # JAX package: optimizer steps per dispatched call
    device_data: bool = False   # keep the corpora resident on the device
    hang_watchdog_secs: float = 0.0  # >0: exit with code 66 when no heartbeat lands
                                # within this many seconds
    cached_prompt_embeddings: bool = False  # per-sample prompt-embedding
                                # table instead of the teacher call on the
                                # inputs (not ported: raises)
    embed_refresh_epochs: int = 1
    fuse_teacher: bool = False  # one teacher forward over both batches (not ported:
                                # raises)

    def vae_config(self) -> VAEConfig:
        return VAEConfig(latent_dim=self.latent_dim, image_size=self.image_size)

    def teacher_config(self) -> TeacherConfig:
        return TeacherConfig(
            num_experts=self.num_experts,
            feature_dim=self.feature_dim,
            embedding_dim=self.embedding_dim,
            image_size=self.image_size,
            attn_window=self.attn_window or None,
        )

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        clean = {k: v for k, v in d.items() if k in names}
        if isinstance(clean.get("mesh_shape"), list):
            clean["mesh_shape"] = tuple(clean["mesh_shape"])
        return cls(**clean)
