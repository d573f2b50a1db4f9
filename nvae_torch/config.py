"""Static configuration for the PyTorch port.

A copy of ``nvae_tpu/config.py``'s ``ModelConfig``, ``StageShapes``,
``shapes()``, ``TrainConfig``, ``debug_config`` and ``MNIST_CONFIG``, and of
``nvae_tpu/presets.py``'s MNIST presets.  The port keeps its own copy so that
it imports nothing of the JAX package; the fields, defaults and shape algebra
are the same, so one configuration means the same network in both packages.

PyTorch modules need their input channel counts up front where Flax infers
them at the first call; :meth:`ModelConfig.shapes` gives every count the
port's constructors need.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _as_tuple(x) -> Tuple[int, ...]:
    if isinstance(x, int):
        return (x,)
    return tuple(int(v) for v in x)


@dataclasses.dataclass(frozen=True)
class StageShapes:
    """Derived static shape algebra for one model configuration."""

    # Spatial side length at the input of each encoder scale, bottom-up.
    enc_scale_sizes: Tuple[int, ...]
    # Channel count of every encoder scale, bottom-up.
    enc_scale_channels: Tuple[int, ...]
    # Spatial side length at each decoder scale, top-down.
    dec_scale_sizes: Tuple[int, ...]
    # Channel count of every decoder scale, top-down.
    dec_scale_channels: Tuple[int, ...]
    # (H, W, C) of the deepest feature map (encoder trunk / decoder start).
    base_size: int
    base_channels_enc: int
    base_channels_dec: int
    # Channel multiplier after the preprocess stem.
    mult_after_preprocess: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (defaults = the NVAE-paper MNIST
    configuration, the ``mnist_step_sn`` preset)."""

    image_size: int = 32
    in_channels: int = 1
    n_encoder_channels: int = 32
    n_decoder_channels: int = 32
    res_cells_per_group: int = 1
    n_preprocess_blocks: int = 2
    n_preprocess_cells: int = 3
    n_postprocess_blocks: int = 2
    n_postprocess_cells: int = 3
    n_latent_per_group: int = 20
    # Bottom-up (encoder order).
    n_groups_per_scale: Tuple[int, ...] = (5, 10)
    scale_factor: int = 2
    sr_lambda: float = 0.01
    se_ratio: int = 16
    expansion_ratio: int = 6
    # Output likelihood: "bernoulli" (MNIST) or "dml" (mixture of discretized
    # logistics).
    likelihood: str = "bernoulli"
    n_mix: int = 10
    # Spectral-norm strategy: "projection", "forward", "penalty" or "none".
    # At inference only "forward" changes the forward pass.
    spectral_mode: str = "projection"
    # Compute dtype for convolutions ("float32" or "bfloat16").
    compute_dtype: str = "float32"
    # Dtype of the BatchNorm normalization apply.
    bn_apply_dtype: str = "float32"
    # Depthwise instead of full 5x5 conv in the postprocess nodes.
    postprocess_5x5_depthwise: bool = False
    # Route the depthwise-5x5 hot spots through the hand-written fused
    # swish->dw5x5 kernel (nvae_torch/kernels/depthwise.py).  The name is
    # kept from the JAX package so one config drives both.
    use_pallas_kernels: bool = False
    # Rematerialize residual cells in the backward pass (training only).
    remat: bool = False
    # Apply sampling temperature to every latent group, not only z0.
    temperature_all_groups: bool = False

    def __post_init__(self):
        object.__setattr__(
            self, "n_groups_per_scale", _as_tuple(self.n_groups_per_scale)
        )
        if self.likelihood not in ("bernoulli", "dml"):
            raise ValueError(f"unknown likelihood {self.likelihood!r}")
        if self.spectral_mode not in ("projection", "forward", "penalty", "none"):
            raise ValueError(f"unknown spectral_mode {self.spectral_mode!r}")
        if self.bn_apply_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown bn_apply_dtype {self.bn_apply_dtype!r}")

    # -- derived -----------------------------------------------------------

    @property
    def n_latent_scales(self) -> int:
        return len(self.n_groups_per_scale)

    @property
    def n_total_groups(self) -> int:
        return sum(self.n_groups_per_scale)

    def shapes(self) -> StageShapes:
        """Validated static shape algebra for the full network."""
        f = self.scale_factor
        size = self.image_size
        mult = 1
        for _ in range(self.n_preprocess_blocks):
            if size % f:
                raise ValueError(
                    f"image_size {self.image_size} not divisible by "
                    f"scale_factor^n_preprocess_blocks"
                )
            size //= f
            mult *= f
        mult_after_pre = mult

        enc_sizes, enc_channels = [], []
        for s in range(self.n_latent_scales):
            enc_sizes.append(size)
            enc_channels.append(self.n_encoder_channels * mult)
            if s < self.n_latent_scales - 1:
                if size % f:
                    raise ValueError("spatial size not divisible at encoder scale")
                size //= f
                mult *= f
        base_size = size
        base_mult = mult

        dec_sizes, dec_channels = [], []
        for s in range(self.n_latent_scales):
            dec_sizes.append(size)
            dec_channels.append(self.n_decoder_channels * mult)
            if s < self.n_latent_scales - 1:
                size *= f
                if mult % f:
                    raise ValueError(
                        "decoder channel multiplier must stay integral"
                    )
                mult //= f

        post_mult = mult
        for _ in range(self.n_postprocess_blocks):
            if post_mult % f:
                raise ValueError(
                    "postprocess channel multiplier must stay integral"
                )
            post_mult //= f

        return StageShapes(
            enc_scale_sizes=tuple(enc_sizes),
            enc_scale_channels=tuple(enc_channels),
            dec_scale_sizes=tuple(dec_sizes),
            dec_scale_channels=tuple(dec_channels),
            base_size=base_size,
            base_channels_enc=self.n_encoder_channels * base_mult,
            base_channels_dec=self.n_decoder_channels * base_mult,
            mult_after_preprocess=mult_after_pre,
        )

    @property
    def z0_shape(self) -> Tuple[int, int, int]:
        s = self.shapes()
        return (s.base_size, s.base_size, self.n_latent_per_group)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer / runtime configuration (reference ``train.py:145-297`` flags)."""

    epochs: int = 400
    batch_size: int = 144
    learning_rate: float = 1e-3
    dataset: str = "mnist"
    seed: int = 1
    # KL warm-up: beta ramps linearly to 1 over the first `warmup_fraction` of
    # training (reference models.py:122 hardcodes 0.3).
    warmup_fraction: float = 0.3
    step_based_warmup: bool = False
    # Reference defect parity: epoch-based warm-up divides the epoch counter by
    # total *steps* (models.py:121-122 + train.py:124), making Epoch+SN warm up
    # ~batches_per_epoch x slower than intended. False = fixed (divide epochs
    # by total epochs); True = bug-for-bug parity.
    parity_epoch_warmup_in_steps: bool = False
    # Reference defect parity: datasets.py:13-15 binarizes with Bernoulli probs
    # in [0,255] (a >0 threshold in practice). False = proper Bernoulli draw
    # from probs in [0,1], redrawn each epoch on device; True = >0 threshold.
    parity_binarize_255: bool = False
    # Reference defect parity: the reference's custom ``train_step`` calls
    # ``self(data)`` with NO ``training`` argument (models.py:117, copied from
    # the keras.io VAE tutorial), and Keras 2 resolves the missing flag to
    # inference mode all the way down.  The reference therefore TRAINS with
    # BatchNorm in inference mode (moving statistics frozen at init 0/1,
    # never updated) and with TFA's SpectralNormalization never running its
    # power iteration (``if training:`` is falsy) — verified by executing the
    # genuine reference code under tf_keras (tools/reference_oracle.py,
    # phase D).  True reproduces that: the train step runs the forward with
    # ``train=False`` (frozen batch_stats, no spectral-u update).  False
    # (default) trains BN on batch statistics and runs the SN update — the
    # intended semantics.
    parity_frozen_norm: bool = False
    binary: bool = True
    debug: bool = False  # truncate dataset to 4 batches (reference train.py:103)
    # Callback frequencies (epochs).
    sample_frequency: int = 5
    evaluate_frequency: int = 10
    log_frequency: int = 1
    model_save_frequency: int = 10
    patience: int = 0  # 0 disables early stopping
    resume_from: int = 0
    n_samples: int = 10
    binary_eval: bool = False
    # Directories.
    model_save_dir: str = "models"
    sample_dir: str = "results"
    tensorboard_log_dir: str = "logs"
    data_dir: str = ""  # where to look for local dataset files
    # Run each epoch as ONE XLA program (lax.scan over a device-resident
    # dataset; zero host round-trips between steps). Requires the training
    # set to fit in HBM as uint8 — true at reference scale.
    scan_epochs: bool = False
    # Exponential moving average of the post-update params (NVAE paper
    # evaluates with EMA weights, decay 0.9999; the reference has no EMA).
    # 0 disables.  Maintained inside the optimizer state (train/optim.py
    # track_ema) so checkpoints/FSDP/scan-epochs inherit it; use
    # --use_ema in test/sample/serve modes to run on the averaged weights.
    ema_decay: float = 0.0
    # Gradient accumulation: split each batch into N microbatches inside the
    # jitted step (lax.scan) — activation memory scales with the microbatch,
    # the optimizer sees the mean full-batch gradient.  Per-step path only
    # (incompatible with scan_epochs, which keeps the reference step shape).
    grad_accum: int = 1
    # Parallelism: number of devices on the data axis (0 = all available).
    data_parallel: int = 0
    # Mesh axis sizes for (data, model); model axis reserved for future TP.
    model_parallel: int = 1
    # Pipeline parallelism (GPipe over the four stage modules,
    # parallel/pipeline.py): >1 places each stage group on its own
    # device(s).  Microbatches are the pipeline's gradient accumulation
    # (0 = same as pipeline_stages); incompatible with scan_epochs and
    # grad_accum>1.  In pipeline mode data_parallel is the DP width WITHIN
    # each stage (0 = devices/stages).
    pipeline_stages: int = 1
    pipeline_microbatches: int = 0
    # Pipeline dispatch schedule: "1f1b" interleaves one backward chain
    # behind each forward chain (peak boundary-activation stash O(stages),
    # independent of microbatch count); "gpipe" is the classic fill-drain
    # (stash O(microbatches)).  Both accumulate per-stage gradients in the
    # same microbatch order, so they are bitwise identical in result.
    pipeline_schedule: str = "1f1b"


# The default MNIST configuration.
MNIST_CONFIG = ModelConfig()


def debug_config(**overrides) -> ModelConfig:
    """A tiny config for fast tests: 2 scales, few groups, small channels."""
    base = dict(
        image_size=32,
        n_encoder_channels=8,
        n_decoder_channels=8,
        n_preprocess_blocks=1,
        n_preprocess_cells=2,
        n_postprocess_blocks=1,
        n_postprocess_cells=2,
        n_latent_per_group=4,
        n_groups_per_scale=(2, 2),
        res_cells_per_group=1,
    )
    base.update(overrides)
    return ModelConfig(**base)


MNIST_PRESETS = (
    "mnist_step_sn",
    "mnist_step_sn_parity",
    "mnist_step_sr",
    "mnist_epoch_sn",
)


def get_preset(name: str) -> ModelConfig:
    """The model half of the JAX package's MNIST presets.

    The presets differ from each other in the spectral-norm strategy and in
    training settings; the training half waits for the port's training
    slice, so this returns the ``ModelConfig`` alone.
    """
    name = name.lower()
    modes = {
        "mnist_step_sn": "projection",
        "mnist_step_sn_parity": "forward",
        "mnist_step_sr": "penalty",
        "mnist_epoch_sn": "projection",
    }
    if name not in modes:
        raise ValueError(
            f"unknown preset {name!r}; available: {', '.join(MNIST_PRESETS)}"
        )
    return ModelConfig(spectral_mode=modes[name])
