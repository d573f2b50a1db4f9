"""The NVAE model (counterpart of ``nvae_tpu/models/nvae.py``).

The posterior pass that training runs (``NVAE.forward``: preprocess ->
bottom-up encoder -> top-down decoder sampling every z from the posterior ->
postprocess -> likelihood head), its eval-mode reconstruction
(``NVAE.reconstruct``) and the prior sampler (``NVAE.sample``).  The head is
Bernoulli (one logit per channel) or a mixture of ``n_mix`` discretized
logistics (``likelihood="dml"``: ``n_mix * (1 + 2 * in_channels)``
channels, split in JAX's order by ``nvae_torch/ops/math.py``).

``remat`` rematerializes every stem, encoder, generative and postprocess
cell under autograd, as JAX's ``nn.remat`` wraps them
(``models/nvae.py:76-81``): ``torch.utils.checkpoint`` keeps a cell's input
and runs the cell again in the backward pass.  The second run updates no
buffer and reads the spectral ``u`` the first run read, since JAX's remat
recomputes a pure function: the BatchNorm running statistics and the
forward-mode ``u`` move once a step, from the first run.

``compute_dtype`` / ``bn_apply_dtype`` bfloat16 run in both modes (train,
sample, reconstruct): the parameters, BatchNorm statistics and spectral
``u`` stay fp32 and each module casts where its JAX module casts
(``nn/spectral.py``, ``nn/blocks.py``); the latent heads and the likelihood
head return fp32, and the noise is drawn in fp32.

Layout: internally every feature map is NCHW in ``torch.channels_last``
memory, so the fused depthwise kernel reads it as NHWC without a transpose.
Public inputs and outputs (images, injected noise, ``last_s``, ``z``) keep the
JAX package's NHWC layout.

Noise: ``generate`` draws ``z0``, then one Gaussian per group ``g >= 1``, then
``z1`` and ``z2``, and ``sample`` then draws the Bernoulli uniforms (or the
DML's Gumbel noise and logistic uniforms): the JAX draw order
(``models/nvae.py:434,454,461-462,547``).  The posterior pass
draws group 0's noise, then one per group ``g >= 1`` (``models/nvae.py:315,
353``).  Each draw comes from the caller's ``torch.Generator``, or from the
injected ``eps`` list and ``uniform`` (and ``gumbel``) tensors, which is how
tests feed both packages the same noise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from nvae_torch.config import ModelConfig
from nvae_torch.device import DeviceLike, resolve_device
from nvae_torch.nn.blocks import (
    BatchNorm,
    DecoderSampleCombiner,
    EncDecCombiner,
    EncoderResidualCell,
    GenerativeResidualCell,
    PostprocessCell,
    Rescaler,
    SqueezeExcitation,
    StemCell,
)
from nvae_torch.nn.spectral import DepthwiseConv, SNConv
from nvae_torch.ops import dml_mean, dml_sample, gaussian_log_prob, softclamp5

SIGMA_FLOOR = 1e-2  # added to every exp(softclamp5(log_sigma)) head


@dataclasses.dataclass
class LatentParams:
    """Posterior and prior parameters of one latent group, NHWC
    (``models/nvae.py:49-58``)."""

    enc_mu: torch.Tensor
    enc_sigma: torch.Tensor
    dec_mu: torch.Tensor
    dec_sigma: torch.Tensor


@dataclasses.dataclass
class ForwardOutput:
    """What the loss needs from one posterior pass (``models/nvae.py:61-69``)."""

    logits: torch.Tensor  # (B, H, W, C_out), NHWC
    latents: List[LatentParams]  # one per group, top-down
    log_p: torch.Tensor  # (B,) sum of prior log-densities (0 unless nll)
    log_q: torch.Tensor  # (B,) sum of posterior log-densities (0 unless nll)


def _sigma(log_sigma_raw: torch.Tensor) -> torch.Tensor:
    return torch.exp(softclamp5(log_sigma_raw)) + SIGMA_FLOOR


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32 at least: bf16 widened, fp32 and float64 kept (JAX's
    ``.astype(jnp.float32)`` of the heads, for a model that may also run in
    float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _as_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    """A ``dtype`` tensor on ``device`` from a tensor or an array (copied,
    so a read-only numpy buffer never backs a tensor)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=dtype)


def _temperature(value, device):
    """A temperature as the sampling arithmetic takes it.  A Python number
    stays a float; an array or tensor becomes float32 on ``device``, copied
    from pinned memory without blocking, so a sampling call enqueues its
    work on the card without waiting for earlier work to finish."""
    if isinstance(value, (int, float)):
        return float(value)
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.array(value, dtype=np.float32))
    value = value.to(torch.float32)
    if value.device.type == "cpu" and device.type == "cuda":
        return value.pin_memory().to(device, non_blocking=True)
    return value.to(device)


DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _check_dtypes(cfg: ModelConfig) -> None:
    for name in ("compute_dtype", "bn_apply_dtype"):
        if getattr(cfg, name) not in DTYPES:
            raise ValueError(f"unknown {name} {getattr(cfg, name)!r}")


def run_cell(cell: nn.Module, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``cell(x)``; under ``remat``, while autograd records, through
    ``torch.utils.checkpoint``: the cell's activations are not kept, and
    the backward pass runs the cell again (launching its fused depthwise
    kernel again) to rebuild them.  No RNG state is stashed (the cells
    draw none, and a stash would break CUDA graph capture)."""
    if not (remat and torch.is_grad_enabled()):
        return cell(x)
    return torch.utils.checkpoint.checkpoint(
        cell, x, use_reentrant=False, preserve_rng_state=False,
        context_fn=functools.partial(_recompute_contexts, cell))


def _recompute_contexts(cell: nn.Module):
    """``(context of the first run, context of the recompute)`` for
    :func:`run_cell`: the first run as it is; the recompute with the
    ``u`` of every training forward-mode convolution as the first run
    read it (copied here, before that run moves it) and no buffer
    update."""
    sns = [m for m in cell.modules()
           if isinstance(m, SNConv) and m.u is not None and m.training]
    with torch.no_grad():
        read = [m.u.clone() for m in sns]
    return contextlib.nullcontext(), _without_updates(cell, sns, read)


@contextlib.contextmanager
def _without_updates(cell: nn.Module, sns: List[SNConv],
                     read: List[torch.Tensor]):
    frozen = [m for m in cell.modules() if isinstance(m, (BatchNorm, SNConv))]
    with torch.no_grad():
        moved = [m.u.clone() for m in sns]
        for m, u in zip(sns, read):
            m.u.copy_(u)
    for m in frozen:
        m.update_buffers = False
    try:
        yield
    finally:
        for m in frozen:
            m.update_buffers = True
        with torch.no_grad():
            for m, u in zip(sns, moved):
                m.u.copy_(u)


class _Noise:
    """Standard-normal and uniform draws, NHWC, from a generator or from
    injected tensors consumed in order."""

    def __init__(self, eps: Optional[Sequence], generator, device,
                 dtype=torch.float32):
        self.eps = None if eps is None else list(eps)
        self.used = 0
        self.generator = generator
        self.device = device
        self.dtype = dtype

    def normal(self, shape) -> torch.Tensor:
        if self.eps is None:
            return torch.randn(shape, generator=self.generator,
                               device=self.device, dtype=self.dtype)
        if self.used >= len(self.eps):
            raise ValueError(f"only {len(self.eps)} eps tensors injected")
        e = _as_tensor(self.eps[self.used], self.device, self.dtype)
        self.used += 1
        if tuple(e.shape) != tuple(shape):
            raise ValueError(
                f"eps[{self.used - 1}] has shape {tuple(e.shape)}, the draw "
                f"needs {tuple(shape)}"
            )
        return e

    def finish(self) -> None:
        if self.eps is not None and self.used != len(self.eps):
            raise ValueError(
                f"{len(self.eps)} eps tensors injected, {self.used} drawn"
            )


class LatentHeads(nn.Module):
    """Per-group parameter heads (``_LatentHeads``, ``models/nvae.py:165-206``):
    ``enc_heads[g]`` a 3x3 conv for the posterior (offsets for g > 0), and
    ``dec_heads[g - 1]`` ELU -> 1x1 conv for the prior of group g >= 1; each
    output splits into (mu, log sigma)."""

    flax_names = {"enc_heads": "enc_heads", "dec_heads": "dec_heads"}

    def __init__(self, cfg: ModelConfig, enc_in: Sequence[int],
                 dec_in: Sequence[int]):
        super().__init__()
        n_out = 2 * cfg.n_latent_per_group
        self.enc_heads = nn.ModuleList(
            SNConv(ch, n_out, 3, mode=cfg.spectral_mode) for ch in enc_in
        )
        self.dec_heads = nn.ModuleList(
            SNConv(ch, n_out, 1, mode=cfg.spectral_mode) for ch in dec_in
        )

    def enc_params(self, group: int, x: torch.Tensor):
        # fp32 whatever the compute dtype: mu and log sigma feed
        # softclamp, exp and the KL.
        return _f32(self.enc_heads[group](x)).chunk(2, dim=1)

    def dec_params(self, group: int, x: torch.Tensor):
        if group < 1:
            raise ValueError("group 0 has a standard-normal prior")
        out = _f32(self.dec_heads[group - 1](F.elu(x)))
        return out.chunk(2, dim=1)


class Decoder(nn.Module):
    """Top-down tower (``_Decoder``), owning the latent heads, the trainable
    constant ``h``, the sample combiners and the enc-dec merges.  ``forward``
    is the posterior pass, ``generate`` the prior pass."""

    flax_names = {
        "heads": "heads", "cells": "cells", "combiners": "combiners",
        "merges": "merges", "rescalers": "rescalers",
    }

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        shapes = cfg.shapes()
        groups_topdown = tuple(reversed(cfg.n_groups_per_scale))
        # The enc-dec merge of a decoder scale outputs that scale's encoder
        # channels (models/nvae.py:221-223, 248-256).
        enc_ch_topdown = tuple(reversed(shapes.enc_scale_channels))
        n_lat = cfg.n_latent_per_group
        cells, combiners, rescalers, merges = [], [], [], []
        enc_in, dec_in = [shapes.base_channels_enc], []
        # plan[g] = (scale of group g, rescale after group g?)
        self.plan = []
        for scale in range(cfg.n_latent_scales):
            ch = shapes.dec_scale_channels[scale]
            for group in range(groups_topdown[scale]):
                first = not self.plan
                cells.append(nn.ModuleList(
                    [] if first else [
                        GenerativeResidualCell(
                            ch, cfg.expansion_ratio, cfg.se_ratio,
                            use_pallas=cfg.use_pallas_kernels,
                            mode=cfg.spectral_mode,
                        )
                        for _ in range(cfg.res_cells_per_group)
                    ]
                ))
                # Group 0 combines the constant h (n_decoder_channels wide)
                # with z0; later groups combine the scale's feature map.
                x_ch = cfg.n_decoder_channels if first else ch
                combiners.append(DecoderSampleCombiner(
                    x_ch, n_lat, ch, mode=cfg.spectral_mode
                ))
                if not first:
                    merges.append(EncDecCombiner(
                        ch, enc_ch_topdown[scale], mode=cfg.spectral_mode
                    ))
                    enc_in.append(enc_ch_topdown[scale])
                    dec_in.append(ch)
                last = group == groups_topdown[scale] - 1
                self.plan.append(
                    (scale, last and scale < cfg.n_latent_scales - 1)
                )
            if scale < cfg.n_latent_scales - 1:
                rescalers.append(Rescaler(
                    ch, shapes.dec_scale_channels[scale + 1], cfg.scale_factor,
                    mode=cfg.spectral_mode,
                ))
        self.heads = LatentHeads(cfg, enc_in, dec_in)
        self.cells = nn.ModuleList(cells)
        self.combiners = nn.ModuleList(combiners)
        self.merges = nn.ModuleList(merges)
        self.rescalers = nn.ModuleList(rescalers)
        self.h = nn.Parameter(torch.empty(
            cfg.n_decoder_channels, shapes.base_size, shapes.base_size
        ))
        with torch.no_grad():
            self.h.uniform_(0.0, 1.0)

    def _start(self, batch: int) -> torch.Tensor:
        x = self.h.unsqueeze(0).expand(batch, -1, -1, -1)
        return x.contiguous(memory_format=torch.channels_last)

    def forward(
        self,
        trunk: torch.Tensor,
        enc_feats_topdown: Sequence[torch.Tensor],
        nll: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        eps: Optional[Sequence] = None,
    ):
        """Posterior pass (``_Decoder.__call__``): sample every z from q.
        ``enc_feats_topdown`` is the encoder's feature list, reversed.
        Returns ``(features NCHW, latents (NHWC), log_p, log_q)``; ``log_p``
        and ``log_q`` are (B,) sums over each group's elements when ``nll``,
        else zeros.  Noise: group 0, then one draw per group g >= 1."""
        batch = trunk.shape[0]
        # The noise is fp32 under a bf16 compute dtype, as JAX draws it (a
        # float64 model draws float64).
        dt = torch.promote_types(trunk.dtype, torch.float32)
        noise = _Noise(eps, generator, trunk.device, dt)
        latents: List[LatentParams] = []
        log_p = torch.zeros(batch, device=trunk.device, dtype=dt)
        log_q = torch.zeros(batch, device=trunk.device, dtype=dt)

        def draw(enc_mu, enc_sigma, dec_mu, dec_sigma):
            nonlocal log_p, log_q
            z = enc_mu + _nchw(noise.normal(_nhwc(enc_mu).shape)) * enc_sigma
            latents.append(LatentParams(*map(
                _nhwc, (enc_mu, enc_sigma, dec_mu, dec_sigma)
            )))
            if nll:
                dims = (1, 2, 3)
                log_q = log_q + gaussian_log_prob(z, enc_mu, enc_sigma).sum(dims)
                log_p = log_p + gaussian_log_prob(z, dec_mu, dec_sigma).sum(dims)
            return z

        # Group 0: posterior from the trunk, standard-normal prior.
        mu_off, ls_off = self.heads.enc_params(0, trunk)
        enc_mu = softclamp5(mu_off)
        enc_sigma = _sigma(ls_off)
        z = draw(enc_mu, enc_sigma, torch.zeros_like(enc_mu),
                 torch.ones_like(enc_sigma))
        x = self.combiners[0](self._start(batch), z)
        rescale_i = 0
        if self.plan[0][1]:
            x = self.rescalers[0](x)
            rescale_i = 1
        for g in range(1, len(self.plan)):
            _, rescale_after = self.plan[g]
            for cell in self.cells[g]:
                x = run_cell(cell, x, self.cfg.remat)
            enc_prior = self.merges[g - 1](enc_feats_topdown[g - 1], x)
            raw_mu, raw_ls = self.heads.dec_params(g, x)
            mu_off, ls_off = self.heads.enc_params(g, enc_prior)
            z = draw(softclamp5(raw_mu + mu_off), _sigma(raw_ls + ls_off),
                     softclamp5(raw_mu), _sigma(raw_ls))
            x = self.combiners[g](x, z)
            if rescale_after:
                x = self.rescalers[rescale_i](x)
                rescale_i += 1
        noise.finish()
        return x, latents, log_p, log_q

    def generate(
        self,
        n_samples: int,
        temperature=1.0,
        scale_temperatures=None,
        *,
        generator: Optional[torch.Generator] = None,
        eps: Optional[Sequence] = None,
    ):
        """Prior pass.  Returns ``(features, last_s, z1, z2)``, NCHW.

        ``temperature`` is a scalar or a per-sample ``(n_samples,)`` vector;
        it scales sigma of z0 only, unless ``cfg.temperature_all_groups``.
        ``scale_temperatures`` (one value per decoder scale, top-down, or a
        ``(n_scales, n_samples)`` array) overrides it for every group of each
        scale.  ``last_s`` is the input of the final group's combiner and
        ``z1``/``z2`` two extra draws from the final group's prior.
        """
        cfg = self.cfg
        dev = self.h.device
        noise = _Noise(eps, generator, dev)
        st = None
        if scale_temperatures is not None:
            st = scale_temperatures
            if not isinstance(st, torch.Tensor):
                st = np.asarray(st, np.float32)
                st = [float(v) for v in st] if st.ndim == 1 else st
            if len(st) != cfg.n_latent_scales:
                raise ValueError(
                    f"scale_temperatures needs {cfg.n_latent_scales} values"
                )
            if not isinstance(st, list):
                st = _temperature(st, dev)
                if st.dim() == 2:
                    if st.shape[1] != n_samples:
                        raise ValueError("scale_temperatures rows != n_samples")
                    st = st[:, :, None, None, None]
        t = _temperature(temperature, dev)
        if isinstance(t, torch.Tensor) and t.dim() == 1:
            if t.shape[0] != n_samples:
                raise ValueError("temperature vector length != n_samples")
            t = t.view(n_samples, 1, 1, 1)

        def group_temp(scale: int, g: int):
            if st is not None:
                return st[scale]
            if g == 0 or cfg.temperature_all_groups:
                return t
            return None  # T = 1: skip the multiply, as the JAX model does

        base = self.h.shape[-1]
        n_lat = cfg.n_latent_per_group
        z0_shape = (n_samples, base, base, n_lat)
        mu = torch.zeros(z0_shape, device=dev)
        sigma = torch.full(z0_shape, 1.0 + SIGMA_FLOOR, device=dev)
        mu, sigma = _nchw(mu), _nchw(sigma) * group_temp(0, 0)
        z = mu + _nchw(noise.normal(z0_shape)) * sigma

        x = self._start(n_samples)
        last_s = x
        x = self.combiners[0](x, z)
        rescale_i = 0
        if self.plan[0][1]:
            x = self.rescalers[0](x)
            rescale_i = 1
        for g in range(1, len(self.plan)):
            scale, rescale_after = self.plan[g]
            for cell in self.cells[g]:
                x = cell(x)
            raw_mu, raw_ls = self.heads.dec_params(g, x)
            mu = softclamp5(raw_mu)
            sigma = _sigma(raw_ls)
            tg = group_temp(scale, g)
            if tg is not None:
                sigma = sigma * tg
            z = mu + _nchw(noise.normal(_nhwc(mu).shape)) * sigma
            last_s = x
            x = self.combiners[g](x, z)
            if rescale_after:
                x = self.rescalers[rescale_i](x)
                rescale_i += 1
        z1 = mu + _nchw(noise.normal(_nhwc(mu).shape)) * sigma
        z2 = mu + _nchw(noise.normal(_nhwc(mu).shape)) * sigma
        noise.finish()
        return x, last_s, z1, z2

    def generate_from_z(self, z: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """Re-run only the final group's combiner with a fixed (z, s), NCHW."""
        return self.combiners[-1](s, z)


class Preprocess(nn.Module):
    """Input map ``2x - 1``, a 3x3 stem conv, then ``n_preprocess_blocks`` x
    (``n_preprocess_cells - 1`` stem cells that keep the size, then one that
    halves it and doubles the width) (``_Preprocess``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.remat = cfg.remat
        # Flax names a rematerialized compact cell after its wrapped class.
        self.flax_names = {"stem": "SNConv_0",
                           "cells": _flax_cell_name("StemCell", cfg)}
        c = cfg.n_encoder_channels
        self.stem = SNConv(cfg.in_channels, c, 3, mode=cfg.spectral_mode)
        cells, mult = [], 1
        for _ in range(cfg.n_preprocess_blocks):
            for _ in range(cfg.n_preprocess_cells - 1):
                cells.append(StemCell(mult * c, mult * c, n_nodes=2,
                                      se_ratio=cfg.se_ratio,
                                      mode=cfg.spectral_mode))
            cells.append(StemCell(mult * c, mult * cfg.scale_factor * c,
                                  n_nodes=2, downsample=True,
                                  se_ratio=cfg.se_ratio,
                                  mode=cfg.spectral_mode))
            mult *= cfg.scale_factor
        self.cells = nn.ModuleList(cells)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(2.0 * x - 1.0)
        for cell in self.cells:
            x = run_cell(cell, x, self.remat)
        return x


class Encoder(nn.Module):
    """Bottom-up tower (``_Encoder``).  ``forward`` returns ``(feats,
    trunk)``: the feature map at each of the ``n_total_groups - 1`` combiner
    points, bottom-up, and the trunk ELU -> 1x1 conv -> ELU."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.remat = cfg.remat
        self.flax_names = {
            "cells": _flax_cell_name("EncoderResidualCell", cfg),
            "rescalers": "Rescaler", "trunk": "SNConv_0"}
        shapes = cfg.shapes()
        chans = shapes.enc_scale_channels
        cells, rescalers = [], []
        # plan: per scale, (cell indices of each group, a feature after it?)
        self.plan = []
        n_scales = cfg.n_latent_scales
        for scale in range(n_scales):
            groups = []
            for group in range(cfg.n_groups_per_scale[scale]):
                idx = []
                for _ in range(cfg.res_cells_per_group):
                    idx.append(len(cells))
                    cells.append(EncoderResidualCell(
                        chans[scale], cfg.se_ratio, mode=cfg.spectral_mode
                    ))
                last = (scale == n_scales - 1
                        and group == cfg.n_groups_per_scale[scale] - 1)
                groups.append((idx, not last))
            self.plan.append(groups)
            if scale < n_scales - 1:
                rescalers.append(Rescaler(
                    chans[scale], chans[scale + 1], cfg.scale_factor,
                    mode=cfg.spectral_mode, up=False,
                ))
        self.cells = nn.ModuleList(cells)
        self.rescalers = nn.ModuleList(rescalers)
        self.trunk = SNConv(chans[-1], shapes.base_channels_enc, 1,
                            mode=cfg.spectral_mode)

    def forward(self, x: torch.Tensor):
        feats: List[torch.Tensor] = []
        for scale, groups in enumerate(self.plan):
            for idx, keep in groups:
                for i in idx:
                    x = run_cell(self.cells[i], x, self.remat)
                if keep:
                    feats.append(x)
            if scale < len(self.rescalers):
                x = self.rescalers[scale](x)
        return feats, F.elu(self.trunk(F.elu(x)))


class Postprocess(nn.Module):
    """n_blocks x n_cells postprocess cells (the first cell of each block
    upscales), then ELU -> 3x3 conv likelihood head (``_Postprocess``):
    ``in_channels`` Bernoulli logits, or ``n_mix * (1 + 2 * in_channels)``
    DML parameters."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.remat = cfg.remat
        self.flax_names = {"cells": _flax_cell_name("PostprocessCell", cfg),
                           "head": "SNConv_0"}
        shapes = cfg.shapes()
        mult = shapes.mult_after_preprocess
        in_ch = shapes.dec_scale_channels[-1]
        cells = []
        for _ in range(cfg.n_postprocess_blocks):
            mult //= cfg.scale_factor
            ch = cfg.n_decoder_channels * mult
            for cell_idx in range(cfg.n_postprocess_cells):
                cells.append(PostprocessCell(
                    in_ch, ch, n_nodes=1, upscale=cell_idx == 0,
                    factor=cfg.scale_factor, se_ratio=cfg.se_ratio,
                    depthwise_5x5=cfg.postprocess_5x5_depthwise,
                    use_pallas=cfg.use_pallas_kernels, mode=cfg.spectral_mode,
                ))
                in_ch = ch
        self.cells = nn.ModuleList(cells)
        out_ch = (cfg.in_channels if cfg.likelihood == "bernoulli"
                  else cfg.n_mix * (1 + 2 * cfg.in_channels))
        self.head = SNConv(in_ch, out_ch, 3, mode=cfg.spectral_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for cell in self.cells:
            x = run_cell(cell, x, self.remat)
        return _f32(self.head(F.elu(x)))


def _flax_cell_name(cls_name: str, cfg: ModelConfig) -> str:
    """The Flax name stem of a cell that a compact module creates: under
    ``remat``, ``nn.remat`` names the wrapped class ``Checkpoint<cls>``.
    (The decoder's cells, made in ``setup``, keep their attribute name.)"""
    return f"Checkpoint{cls_name}" if cfg.remat else cls_name


class NVAE(nn.Module):
    """The full model.  Public methods (NHWC in and out):

    - ``forward(x, nll)`` -> :class:`ForwardOutput`: the posterior pass;
    - ``sample(n, temperature)`` -> (images, last_s, z1, z2);
    - ``sample_with_z(z, s)`` -> images;
    - ``reconstruct(x)`` -> images (an eval-mode posterior pass).

    ``self.training`` is the JAX model's ``train`` flag.  The model is built
    in eval mode; a trainer calls ``.train()``.  ``device`` defaults to the
    card and raises if there is none; ``seed`` initialises the weights as
    Flax would (glorot-uniform kernels, zero biases, unit BatchNorm,
    ``h ~ U[0, 1)``).  ``device="meta"`` builds the structure alone, with
    no weights, for a caller that binds its own (the serving sampler).
    """

    flax_names = {"preprocess": "preprocess", "encoder": "encoder",
                  "decoder": "decoder", "postprocess": "postprocess"}

    def __init__(self, cfg: ModelConfig, device: DeviceLike = "cuda",
                 seed: int = 0):
        super().__init__()
        _check_dtypes(cfg)
        meta = torch.device(device).type == "meta"
        dev = None if meta else resolve_device(device)
        self.cfg = cfg
        # Built without storage: ``reset_parameters`` draws every parameter
        # and buffer from the seed, so the modules' own initial draws would
        # be thrown away (half of a full-width init's seconds).
        with torch.device("meta"):
            self.preprocess = Preprocess(cfg)
            self.encoder = Encoder(cfg)
            self.decoder = Decoder(cfg)
            self.postprocess = Postprocess(cfg)
        set_dtypes(self, cfg)
        if not meta:
            self.to_empty(device="cpu")
            self.reset_parameters(seed)
            self.to(device=dev, memory_format=torch.channels_last)
        self.eval()

    def reset_parameters(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(int(seed))
        leaves = (SNConv, DepthwiseConv, BatchNorm, SqueezeExcitation)
        for m in self.modules():
            if isinstance(m, leaves):
                m.reset_parameters(gen)
        with torch.no_grad():
            self.decoder.h.uniform_(0.0, 1.0, generator=gen)

    def _to_images(self, logits: torch.Tensor, greyscale: bool,
                   generator: Optional[torch.Generator] = None, uniform=None,
                   gumbel=None) -> torch.Tensor:
        """Images, NHWC, from NHWC head output (``_to_images``): Bernoulli
        probabilities or DML means when ``greyscale``, else a draw
        (Bernoulli: ``u < p``; DML: :func:`~nvae_torch.ops.dml_sample`).
        ``uniform`` (and for DML ``gumbel``) inject the draw's noise."""
        cfg = self.cfg
        if cfg.likelihood != "bernoulli":
            if greyscale:
                return dml_mean(logits, cfg.n_mix, cfg.in_channels)
            return dml_sample(logits, cfg.n_mix, cfg.in_channels,
                              generator=generator, gumbel=gumbel,
                              uniform=uniform)
        probs = torch.sigmoid(logits)
        if greyscale:
            return probs
        if uniform is None:
            u = torch.rand(probs.shape, generator=generator,
                           device=probs.device)
        else:
            u = _as_tensor(uniform, probs.device)
            if tuple(u.shape) != tuple(probs.shape):
                raise ValueError(f"uniform must have shape "
                                 f"{tuple(probs.shape)}")
        return (u < probs).to(torch.float32)

    def forward(
        self,
        x,
        nll: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        eps: Optional[Sequence] = None,
    ) -> ForwardOutput:
        """Posterior pass on images ``x`` (B, H, W, C) in [0, 1]
        (``NVAE.__call__``).  ``eps`` injects the posterior noise (a list of
        NHWC tensors: group 0, then each group g >= 1), else each draw comes
        from ``generator``.  The pass runs in the model's dtype (float32;
        a float64 copy on the CPU serves as a reference), each module in the
        config's compute dtypes."""
        h = self.decoder.h
        x = _nchw(_as_tensor(x, h.device, _f32(h).dtype))
        x = x.contiguous(memory_format=torch.channels_last)
        enc_feats, trunk = self.encoder(self.preprocess(x))
        feats, latents, log_p, log_q = self.decoder(
            trunk, enc_feats[::-1], nll, generator=generator, eps=eps,
        )
        logits = self.postprocess(feats)
        return ForwardOutput(_nhwc(logits), latents, log_p, log_q)

    @torch.no_grad()
    def sample(
        self,
        n_samples: int = 16,
        temperature=1.0,
        greyscale: bool = True,
        scale_temperatures=None,
        *,
        generator: Optional[torch.Generator] = None,
        eps: Optional[Sequence] = None,
        uniform=None,
        gumbel=None,
    ):
        """Unconditional samples: ``(images, last_s, z1, z2)``, NHWC.

        ``greyscale`` returns the Bernoulli probabilities (DML: the
        mixture's mean); otherwise draws (binary ``u < p``; DML:
        :func:`~nvae_torch.ops.dml_sample`).  ``eps`` injects the Gaussian
        draws (a list of NHWC tensors in the draw order), ``uniform`` the
        Bernoulli or logistic uniforms and ``gumbel`` the DML component's
        Gumbel noise."""
        feats, last_s, z1, z2 = self.decoder.generate(
            n_samples, temperature, scale_temperatures,
            generator=generator, eps=eps,
        )
        logits = _nhwc(self.postprocess(feats))
        images = self._to_images(logits, greyscale, generator, uniform,
                                 gumbel)
        return images, _nhwc(last_s), _nhwc(z1), _nhwc(z2)

    @torch.no_grad()
    def reconstruct(self, x, *, generator: Optional[torch.Generator] = None,
                    eps: Optional[Sequence] = None) -> torch.Tensor:
        """Reconstructions of images ``x`` (B, H, W, C) in [0, 1]
        (``NVAE.reconstruct``): a posterior pass in eval mode (running
        BatchNorm statistics, no buffer written) whose greyscale images
        (Bernoulli probabilities, or the DML mixture's mean) are returned,
        NHWC.  ``eps`` injects the posterior
        noise, else each draw comes from ``generator``.  The model's mode is
        put back afterwards."""
        was = self.training
        self.eval()
        try:
            out = self(x, generator=generator, eps=eps)
        finally:
            self.train(was)
        return self._to_images(out.logits, greyscale=True)

    @torch.no_grad()
    def sample_with_z(self, z: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """Greyscale images (probabilities, or the DML mixture's mean) from
        the final group's (z, s), NHWC."""
        dev = self.decoder.h.device
        z, s = _nchw(_as_tensor(z, dev)), _nchw(_as_tensor(s, dev))
        logits = self.postprocess(self.decoder.generate_from_z(z, s))
        return self._to_images(_nhwc(logits), greyscale=True)


def set_dtypes(model: nn.Module, cfg: ModelConfig) -> None:
    """Give every leaf module the config's dtypes, where the JAX model
    passes ``dtype=compute_dtype`` and ``bn_dtype=bn_apply_dtype``: every
    convolution, depthwise convolution and squeeze-excitation block, and
    every BatchNorm."""
    dt, bn = DTYPES[cfg.compute_dtype], DTYPES[cfg.bn_apply_dtype]
    for m in model.modules():
        if isinstance(m, (SNConv, DepthwiseConv, SqueezeExcitation)):
            m.dtype = dt
        elif isinstance(m, BatchNorm):
            m.apply_dtype = bn


@contextlib.contextmanager
def discard_buffer_updates(model: nn.Module, train: bool = True):
    """Run passes in training mode (``train``; else eval mode) and throw
    their buffer updates away, as the JAX package's ``mutable=[...]`` passes
    discard theirs: on exit every buffer (BatchNorm running statistics,
    forward-mode spectral ``u``) holds the bits it held on entry and the
    model is back in its old mode.  Yields a function that puts the buffers
    back early, between passes that must each start from them."""
    was = model.training
    buffers = list(model.buffers())
    saved = [torch.empty_like(b) for b in buffers]
    with torch.no_grad():
        if buffers:
            torch._foreach_copy_(saved, buffers)

    def restore() -> None:
        with torch.no_grad():
            if buffers:
                torch._foreach_copy_(buffers, saved)

    model.train(train)
    try:
        yield restore
    finally:
        restore()
        model.train(was)


def posterior_noise_shapes(cfg: ModelConfig, batch: int) -> List[tuple]:
    """NHWC shapes of the Gaussian draws of one posterior pass, in order:
    group 0, then one per group g >= 1."""
    shapes = cfg.shapes()
    n_lat = cfg.n_latent_per_group
    sizes = [shapes.dec_scale_sizes[scale]
             for scale, n in enumerate(reversed(cfg.n_groups_per_scale))
             for _ in range(n)]
    return [(batch, s, s, n_lat) for s in sizes]


def decoder_noise_shapes(cfg: ModelConfig, n_samples: int) -> List[tuple]:
    """NHWC shapes of the Gaussian draws of one ``generate`` call, in order:
    z0, one per group g >= 1, z1, z2."""
    out = posterior_noise_shapes(cfg, n_samples)
    return out + [out[-1], out[-1]]
