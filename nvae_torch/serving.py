"""Serving: a hot-swappable prior sampler on the device, its weight-only
serving dtypes, and its one-file artifact (counterpart of
``nvae_tpu/serving.py``: ``QuantizedLeaf``, ``quantize_params_int8``,
``dequantize_params``, ``cast_params``, ``quantize_output``,
``variables_from_state``, ``ReloadableSampler``, ``make_checkpoint_reloader``,
``build_mesh_sampler``, ``export_sampler`` and ``load_artifact``).

The artifact comes in two forms: the program (:func:`export_program`, a
``torch.export`` graph with the weights inside, which a host runs with
torch and ``nvae_torch.kernels`` alone, as JAX's serialized StableHLO runs
with jax alone) and the weights file (:func:`export_sampler`, the config and
the tensors, which :func:`load_artifact` rebuilds into a :class:`Sampler`
with the model code).

:class:`Sampler` is called as ``(seed, temperature) -> images``; a
temperature vector's length sets the batch size, so one sampler backs
several batch shapes.  It holds the tensors ``NVAE.sample`` reads
(:func:`sampler_keys`: the decoder's prior side and the postprocess, 24.08M
of the default model's 40.1M parameters) as one dict on the device, in its
``serve_dtype``:

- ``""``: as trained (fp32);
- ``"bfloat16"``: every float parameter cast to bf16;
- ``"int8"``: JAX's symmetric per-output-channel int8 of every float
  parameter with at least 4096 elements and two axes, ``scale =
  max(absmax, 1e-12) / 127``, ``q = clip(round(w / scale), -127, 127)``
  (round half to even), dequantized inside every call as ``(q * scale)``
  in the original dtype.

BatchNorm running statistics and spectral ``u`` are buffers, not
parameters: they stay fp32, as JAX casts ``params`` only.  The model's
``compute_dtype`` is separate: bf16 weights under fp32 compute run in fp32
(each module casts, as the JAX modules do).

Hot swap (the reference's shape, ``nvae_tpu/serving.py:254-261``):
:meth:`Sampler.swap` builds the new tensors on the device outside any lock,
as new tensors on the current stream (never copied into the old ones in
place, so the caching allocator reuses the old memory only after the work
already enqueued on that stream), and takes the lock only to replace the
dict's reference and bump ``generation`` and ``step``.  A call reads the
reference once, at its start, and holds no lock while it enqueues its work:
it computes with that one generation throughout, whatever swaps land
meanwhile.  :attr:`Sampler.info` takes the lock only to read three fields.

The module itself carries no weights (its tensors live on the ``meta``
device): a call binds the snapshot's tensors into it for its duration, the
way ``torch.func.functional_call`` does, at a few dict writes per tensor.
That binding is safe only while one thread calls at a time, which is what
the dynamic-batching server does (one dispatch thread); a second
concurrent call raises.

fp32 serving runs with TF32 off and deterministic cuDNN algorithms
(:func:`nvae_torch.device.fp32_math`), so a ``(seed, temperature)`` replays
bitwise on one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from nvae_torch.config import ModelConfig
from nvae_torch.convert import channel_axes
from nvae_torch.device import DeviceLike, fp32_math, resolve_device
from nvae_torch.models.nvae import NVAE, decoder_noise_shapes
from nvae_torch.parallel.multihost import is_primary
from nvae_torch.serving_program import (
    PROGRAM_FORMAT,
    is_program,
    load_program,
    op_nodes,
    save_program,
)

SERVE_DTYPES = ("", "bfloat16", "int8")  # "": as trained (float32)
INT8_MIN_ELEMS = 4096
# The weights file's format tag; the program's is PROGRAM_FORMAT.
ARTIFACT_FORMAT = "nvae_torch.sampler/1"
# The state-dict entries NVAE.sample reads: the decoder's cells, sample
# combiners, rescalers, prior heads and constant input, and the postprocess.
_SAMPLER_PREFIXES = ("decoder.cells.", "decoder.combiners.",
                     "decoder.rescalers.", "decoder.heads.dec_heads.",
                     "postprocess.")


@dataclasses.dataclass
class QuantizedLeaf:
    """A weight stored as int8 ``q`` (its shape) and fp32 per-output-channel
    ``scale`` (size 1 on every other axis): ``w ~ q * scale``."""

    q: torch.Tensor
    scale: torch.Tensor
    orig_dtype: torch.dtype = torch.float32

    def dequantize(self) -> torch.Tensor:
        # int8 * fp32 promotes q to fp32 exactly, then one multiply: JAX's
        # q.astype(float32) * scale.
        return (self.q * self.scale).to(self.orig_dtype)

    def to(self, device) -> "QuantizedLeaf":
        return QuantizedLeaf(self.q.to(device, copy=True),
                             self.scale.to(device, copy=True),
                             self.orig_dtype)

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.scale.nbytes


Leaf = Union[torch.Tensor, QuantizedLeaf]


def quantize_leaf(x: torch.Tensor, axis: int) -> QuantizedLeaf:
    """Symmetric int8 of ``x`` per index of ``axis`` (JAX's rule)."""
    dims = tuple(d for d in range(x.dim()) if d != axis)
    absmax = x.abs().amax(dim=dims, keepdim=True)
    # A tensor divisor on x's device: CUDA turns division by a Python
    # number into a multiply by its reciprocal, which rounds otherwise.
    scale = torch.clamp(absmax.to(torch.float32), min=1e-12) / torch.tensor(
        127.0, device=x.device)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return QuantizedLeaf(q.to(torch.int8), scale, x.dtype)


def _int8_eligible(x: torch.Tensor, min_elems: int) -> bool:
    return x.is_floating_point() and x.numel() >= min_elems and x.dim() >= 2


def quantize_params_int8(params: Dict[str, torch.Tensor],
                         axes: Dict[str, int],
                         min_elems: int = INT8_MIN_ELEMS) -> Dict[str, Leaf]:
    """Per-output-channel int8 of the large float parameters; the rest
    (biases, BatchNorm scales) stay as they are.  ``axes`` gives each
    parameter's output-channel axis (:func:`nvae_torch.convert.channel_axes`:
    the axis JAX reduces last, wherever the port's layout puts it)."""
    return {k: quantize_leaf(v, axes[k]) if _int8_eligible(v, min_elems)
            else v for k, v in params.items()}


def dequantize_params(params: Dict[str, Leaf]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_params_int8` (identity on tensors)."""
    return {k: v.dequantize() if isinstance(v, QuantizedLeaf) else v
            for k, v in params.items()}


def cast_params(params: Dict[str, torch.Tensor],
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The float parameters cast to ``dtype``; pass parameters only, so
    BatchNorm statistics stay fp32."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in params.items()}


def quantize_output(images: torch.Tensor, output_dtype: str) -> torch.Tensor:
    """Device-side output quantization: ``"uint8"`` gives
    ``round(clip(p, 0, 1) * 255)`` (round half to even, as ``jnp.round``), so
    the device-to-host copy carries one byte per pixel.  ``""`` and
    ``"float32"`` are the identity."""
    if output_dtype in ("", "float32"):
        return images
    if output_dtype == "uint8":
        x = torch.clamp(images.to(torch.float32), 0.0, 1.0)
        return torch.round(x * 255.0).to(torch.uint8)
    raise ValueError(f"unknown output_dtype {output_dtype!r}")


def sampler_keys(keys) -> list:
    """The entries of a model state dict that ``NVAE.sample`` reads."""
    return [k for k in keys
            if k.startswith(_SAMPLER_PREFIXES) or k == "decoder.h"]


def variables_from_state(state, use_ema: bool = False) -> dict:
    """The serving state dict of a train state: the model's parameters and
    buffers, with ``use_ema`` the optimizer's EMA average in place of the
    parameters (raises if the state was trained without ``ema_decay``)."""
    from nvae_torch.train.optim import find_ema_params

    sd = dict(state.model.state_dict())
    if use_ema:
        ema = find_ema_params(state.opt_state)
        if ema is None:
            raise ValueError(
                "no EMA in the optimizer state: train with --ema_decay")
        sd.update(ema)
    return sd


class Sampler:
    """Hot-swappable ``(seed, temperature) -> images`` prior sampler.

    ``seed`` seeds a fresh ``torch.Generator`` on the device for the call, so
    the same ``(seed, temperature)`` gives the same images bitwise on one
    device.  ``temperature`` is a float (``n_samples`` images) or a
    per-sample vector whose length is the batch size; a vector on the CPU
    reaches the card by a non-blocking copy, so a call only enqueues work.
    ``scale_temperatures`` fixes per-scale temperatures for every call (they
    override ``temperature``, as in the JAX sampler).  ``output_dtype=
    "uint8"`` quantizes the images on the device (:func:`quantize_output`);
    ``serve_dtype`` applies the weight-only serving cast to the weights
    given here and to every tree swapped in.

    ``device`` defaults to the card and raises if there is none.  The
    weights come from ``state_dict`` (the model's, a checkpoint's through
    :func:`variables_from_state`, :func:`nvae_torch.convert.
    state_dict_from_flax` of a JAX tree, or an artifact's already cast or
    quantized tensors), or from a Flax-style initialisation seeded by
    ``init_seed``.
    """

    def __init__(self, cfg: ModelConfig, state_dict: Optional[dict] = None,
                 n_samples: int = 16,
                 scale_temperatures: Optional[Sequence[float]] = None,
                 output_dtype: str = "", device: DeviceLike = "cuda",
                 init_seed: int = 0, serve_dtype: str = ""):
        quantize_output(torch.zeros(1), output_dtype)  # validate early
        if serve_dtype not in SERVE_DTYPES:
            raise ValueError(f"unknown serve_dtype {serve_dtype!r}")
        self.device = resolve_device(device)
        if state_dict is None:
            state_dict = NVAE(cfg, device="cpu", seed=init_seed).state_dict()
        model = NVAE(cfg, device="meta")
        self.cfg = cfg
        self.keys = sampler_keys(model.state_dict())
        self._params = {k for k, _ in model.named_parameters()}
        self._axes = channel_axes(model)
        self.model = model
        self._slots = {}
        for k in self.keys:
            owner, _, name = k.rpartition(".")
            mod = self.model.get_submodule(owner)
            self._slots[k] = (mod._parameters if name in mod._parameters
                              else mod._buffers, name)
        self.n_samples = int(n_samples)
        self._st = (tuple(float(t) for t in scale_temperatures)
                    if scale_temperatures else None)
        self.output_dtype = output_dtype
        self.serve_dtype = serve_dtype
        self.generation = 0
        self.step = -1  # checkpoint step served; -1 = constructor weights
        self._lock = threading.Lock()
        self._calling = threading.Lock()
        self._weights = self._stage(state_dict)

    # ---- weights ------------------------------------------------------------

    def _stage(self, state_dict: dict) -> Dict[str, Leaf]:
        """New device tensors of the served entries of ``state_dict``, the
        parameters cast or quantized to ``serve_dtype``."""
        missing = [k for k in self.keys if k not in state_dict]
        if missing:
            raise KeyError(f"the sampler needs {missing[:3]} "
                           f"({len(missing)} missing)")
        sd = {k: state_dict[k] for k in self.keys}
        if self.serve_dtype != "int8" and any(
                isinstance(v, QuantizedLeaf) for v in sd.values()):
            raise ValueError(f"int8 weights given to a sampler that serves "
                             f"{self.serve_dtype or 'float32'}")
        params = {k: v.detach() for k, v in sd.items() if k in self._params
                  and isinstance(v, torch.Tensor) and v.is_floating_point()}
        if self.serve_dtype == "bfloat16":
            sd.update(cast_params(params, torch.bfloat16))
        elif self.serve_dtype == "int8":
            sd.update(quantize_params_int8(
                {k: v.to(self.device) for k, v in params.items()},
                self._axes))
        return {k: self._to_device(v) for k, v in sd.items()}

    def _to_device(self, v: Leaf) -> Leaf:
        if isinstance(v, QuantizedLeaf):
            return v.to(self.device)
        t = v.detach().to(self.device, copy=True)
        if t.dim() == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        return t

    @property
    def weights_bytes(self) -> int:
        """Bytes of the served weights on the device."""
        return sum(v.nbytes for v in self._weights.values())

    @contextlib.contextmanager
    def _bound(self, tensors: Dict[str, torch.Tensor]):
        slots = [(self._slots[k], t) for k, t in tensors.items()]
        old = [d[name] for (d, name), _ in slots]
        for (d, name), t in slots:
            d[name] = t
        try:
            yield self.model
        finally:
            for ((d, name), _), t in zip(slots, old):
                d[name] = t

    def apply(self, fn):
        """``fn(model)`` on one snapshot of the served weights, bound into
        the model for the call, in inference mode.  One thread at a time."""
        weights = self._weights  # one generation for the whole call
        if not self._calling.acquire(blocking=False):
            raise RuntimeError("a Sampler is called from one thread at a "
                               "time (its dispatch thread)")
        try:
            with torch.inference_mode(), fp32_math(deterministic=True):
                # int8 leaves dequantized here, one multiply each.
                with self._bound(dequantize_params(weights)) as model:
                    return fn(model)
        finally:
            self._calling.release()

    def __call__(self, seed: int, temperature) -> torch.Tensor:
        n = self.n_samples
        if not isinstance(temperature, (int, float)):
            if not isinstance(temperature, torch.Tensor):
                temperature = np.asarray(temperature, np.float32)
            if temperature.ndim:
                n = temperature.shape[0]
        gen = torch.Generator(device=self.device).manual_seed(int(seed))

        def sample(model):
            images, _, _, _ = model.sample(n, temperature, True, self._st,
                                           generator=gen)
            return quantize_output(images, self.output_dtype)

        return self.apply(sample)

    def swap(self, state_dict: dict, step: Optional[int] = None) -> None:
        """Serve ``state_dict`` (raw weights, cast here to ``serve_dtype``)
        from the next call on; calls already running finish on the old."""
        staged = self._stage(state_dict)
        with self._lock:
            self._weights = staged
            self.generation += 1
            if step is not None:
                self.step = int(step)

    @property
    def info(self) -> dict:
        with self._lock:
            step, generation = self.step, self.generation
        return {
            "step": step,
            "generation": generation,
            "serve_dtype": self.serve_dtype or "float32",
            "output_dtype": self.output_dtype or "float32",
            "device": str(self.device),
        }


def make_checkpoint_reloader(sampler: Sampler, ckpt_dir: str, state_template,
                             use_ema: bool = False):
    """The serving tier's ``POST /reload`` hook: restore a step from the
    checkpoint directory configured at startup (never a client-supplied
    path) into ``state_template`` and swap it into ``sampler``.  ``req``
    keys: ``step`` (int, default the latest), ``use_ema`` (bool, default
    the server's startup setting), ``if_newer`` (follow mode: skip unless a
    step beyond the one serving exists).  Returns the JSON-able record."""
    from nvae_torch.train.checkpoint import latest_step, restore_checkpoint

    ckpt_dir = os.path.abspath(ckpt_dir)

    def reload(req: dict) -> dict:
        step = req.get("step")
        if step is not None and (not isinstance(step, int)
                                 or isinstance(step, bool)):
            raise ValueError(f"step must be an int, got {step!r}")
        ema = req.get("use_ema", use_ema)
        if not isinstance(ema, bool):
            raise ValueError(f"use_ema must be a bool, got {ema!r}")
        if req.get("if_newer") and step is None:
            newest = latest_step(ckpt_dir)
            if newest is None or newest <= sampler.step:
                return {**sampler.info, "skipped": True}
        state = restore_checkpoint(ckpt_dir, state_template, step)
        sampler.swap(variables_from_state(state, ema), step=int(state.step))
        return {**sampler.info, "use_ema": ema}

    return reload


# ---- data-parallel serving -------------------------------------------------


class MeshSampler:
    """A :class:`Sampler` whose batch is split over the ranks of a data
    mesh (``parallel.mesh.DataMesh``), called as ``(seed, temperature) ->
    images`` on rank 0 (see :func:`build_mesh_sampler`).

    Rank 0 drives: per call it broadcasts ``(seed, batch)`` and the
    per-sample temperatures, every rank samples its rows of the global
    draw (the noise a single device draws for the whole batch, of which
    each rank keeps its rows), and rank 0 gathers the images.  The other
    ranks sit in :meth:`follow` until rank 0's :meth:`close`.  The images
    are the single-device sampler's for the same ``(seed, temperature)``:
    bitwise where each row's arithmetic does not depend on the batch size
    (a convolution's algorithm may)."""

    _STOP, _SAMPLE = 0, 1

    def __init__(self, sampler: Sampler, mesh, n_samples: int):
        self.sampler, self.mesh = sampler, mesh
        self.n_samples = int(n_samples)
        self._closed = False

    @property
    def info(self) -> dict:
        return {**self.sampler.info, "ranks": self.mesh.size}

    def _sample_rows(self, seed: int, temps: torch.Tensor) -> torch.Tensor:
        sampler, n = self.sampler, temps.shape[0]
        rows = self.mesh.rows(n)
        gen = torch.Generator(device=sampler.device).manual_seed(int(seed))

        def sample(model):
            eps = [torch.randn(s, generator=gen, device=sampler.device)[rows]
                   for s in decoder_noise_shapes(sampler.cfg, n)]
            images, _, _, _ = model.sample(rows.stop - rows.start,
                                           temps[rows], True, sampler._st,
                                           eps=eps)
            return quantize_output(images, sampler.output_dtype)

        return sampler.apply(sample)

    def _header(self, cmd: int, seed: int = 0, n: int = 0) -> torch.Tensor:
        return torch.tensor([cmd, seed, n], dtype=torch.int64,
                            device=self.mesh.device)

    def __call__(self, seed: int, temperature) -> torch.Tensor:
        if not is_primary():
            raise RuntimeError("rank 0 calls the mesh sampler; the other "
                               "ranks follow()")
        temps = torch.as_tensor(np.asarray(temperature, np.float32)
                                if not isinstance(temperature, torch.Tensor)
                                else temperature, dtype=torch.float32)
        if temps.dim() == 0:
            temps = temps.expand(self.n_samples)
        n = temps.shape[0]
        if n % self.mesh.size:
            raise ValueError(f"batch {n} not divisible by {self.mesh.size} "
                             f"ranks")
        temps = temps.to(self.mesh.device).contiguous()
        self.mesh.broadcast_(self._header(self._SAMPLE, seed, n))
        self.mesh.broadcast_(temps)
        return self.mesh.all_gather_rows(self._sample_rows(seed, temps))

    def follow(self) -> int:
        """The loop of a rank other than 0: sample its rows of every call
        rank 0 makes, until rank 0 closes.  SIGTERM and SIGINT are ignored
        meanwhile: rank 0 drains its server and then stops the others.
        Returns the number of calls followed."""
        import signal

        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, signal.SIG_IGN)
        calls = 0
        while True:
            header = self.mesh.broadcast_(self._header(self._STOP))
            cmd, seed, n = header.tolist()
            if cmd == self._STOP:
                return calls
            temps = torch.empty(n, dtype=torch.float32,
                                device=self.mesh.device)
            self.mesh.broadcast_(temps)
            self.mesh.all_gather_rows(self._sample_rows(seed, temps))
            calls += 1

    def close(self) -> None:
        """Rank 0: release the followers (once)."""
        if is_primary() and not self._closed:
            self._closed = True
            self.mesh.broadcast_(self._header(self._STOP))


def build_mesh_sampler(cfg: ModelConfig, state_dict: dict, n_samples: int,
                       mesh, scale_temperatures: Optional[Sequence[float]]
                       = None, output_dtype: str = "",
                       serve_dtype: str = "") -> MeshSampler:
    """Data-parallel sampler over the ranks of ``mesh`` (counterpart of
    JAX's ``build_mesh_sampler``): the weights replicated on every rank's
    device, each call's ``n_samples`` rows split over the ranks.  Every
    rank builds it; rank 0 calls it and the others :meth:`MeshSampler.
    follow`.  A temperature is a float or a per-sample vector (JAX's
    ``per_sample_temperature``).  Raises ``ValueError`` when ``n_samples``
    does not split over the ranks."""
    if n_samples % mesh.size:
        raise ValueError(f"serving batch {n_samples} not divisible by the "
                         f"data axis {mesh.size}")
    sampler = Sampler(cfg, state_dict, n_samples, scale_temperatures,
                      output_dtype, device=mesh.device,
                      serve_dtype=serve_dtype)
    return MeshSampler(sampler, mesh, n_samples)


# ---- the serving artifact ----------------------------------------------------


def _config_dict(cfg: ModelConfig) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cfg).items()}


def export_sampler(path: str, cfg: ModelConfig, state_dict: dict,
                   n_samples: int,
                   scale_temperatures: Optional[Sequence[float]] = None,
                   per_sample_temperature: bool = False,
                   output_dtype: str = "", serve_dtype: str = "",
                   step: int = -1) -> int:
    """Write the sampler as one file a server loads without the training
    tree: the model config, ``n_samples``, ``scale_temperatures``,
    ``output_dtype``, ``per_sample_temperature``, and only the tensors
    ``NVAE.sample`` reads, already cast or quantized to ``serve_dtype``.
    It is ``torch.save`` of a dict of plain tensors, numbers and strings
    (``torch.load(..., weights_only=True)`` reads it).  Returns the file's
    bytes."""
    staged = Sampler(cfg, state_dict, n_samples, scale_temperatures,
                     output_dtype, device="cpu", serve_dtype=serve_dtype)
    plain, quantized = {}, {}
    for k, v in staged._weights.items():
        if isinstance(v, QuantizedLeaf):
            quantized[k] = {"q": v.q, "scale": v.scale,
                            "orig_dtype": str(v.orig_dtype).split(".")[-1]}
        else:
            plain[k] = v
    payload = {
        "format": ARTIFACT_FORMAT,
        "config": _config_dict(cfg),
        "n_samples": int(n_samples),
        "scale_temperatures": (list(staged._st) if staged._st else None),
        "per_sample_temperature": bool(per_sample_temperature),
        "output_dtype": output_dtype,
        "serve_dtype": serve_dtype,
        "step": int(step),
        "tensors": plain,
        "quantized": quantized,
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return os.path.getsize(path)


class _SamplerProgram(torch.nn.Module):
    """``NVAE.sample`` at one batch over a staged :class:`Sampler`'s
    weights, the module :func:`export_program` traces.  The weights are its
    buffers (dots in their names become ``__``; an int8 leaf is two,
    ``__q`` and ``__scale``, dequantized here as :meth:`QuantizedLeaf.
    dequantize` does); the sampler, whose model lives on the meta device,
    stays outside the module tree, and each call binds the buffers into its
    model as :meth:`Sampler.apply` binds a snapshot."""

    def __init__(self, sampler: Sampler):
        super().__init__()
        self._sampler = (sampler,)
        self._plain, self._quantized = {}, {}
        for k, v in sampler._weights.items():
            name = k.replace(".", "__")
            if isinstance(v, QuantizedLeaf):
                self.register_buffer(f"{name}__q", v.q)
                self.register_buffer(f"{name}__scale", v.scale)
                self._quantized[k] = (name, v.orig_dtype)
            else:
                self.register_buffer(name, v)
                self._plain[k] = name

    def forward(self, temperature: torch.Tensor, eps: list) -> torch.Tensor:
        sampler = self._sampler[0]
        weights = {k: getattr(self, n) for k, n in self._plain.items()}
        for k, (n, dtype) in self._quantized.items():
            weights[k] = QuantizedLeaf(getattr(self, f"{n}__q"),
                                       getattr(self, f"{n}__scale"),
                                       dtype).dequantize()
        with sampler._bound(weights) as model:
            images, _, _, _ = model.sample(sampler.n_samples, temperature,
                                           True, sampler._st, eps=eps)
        return quantize_output(images, sampler.output_dtype)


def export_program(path: str, cfg: ModelConfig, state_dict: dict,
                   n_samples: int,
                   scale_temperatures: Optional[Sequence[float]] = None,
                   per_sample_temperature: bool = False,
                   output_dtype: str = "", serve_dtype: str = "",
                   step: int = -1, device: DeviceLike = "cuda") -> int:
    """Write the sampler as a program (counterpart of JAX's
    ``export_sampler``): ``torch.export`` of ``NVAE.sample`` at batch
    ``n_samples``, with ``scale_temperatures`` and ``output_dtype`` in the
    graph, the served weights (cast or quantized to ``serve_dtype``) as its
    buffers, and #2 as the op ``nvae_torch::fused_swish_dw5x5``.  Its
    inputs are a temperature, ``f32[n_samples]`` with
    ``per_sample_temperature`` else ``f32[]``, and the sampler's Gaussian
    draws (:mod:`nvae_torch.serving_program` loads and runs it without the
    model code).  Traced on ``device`` (the card by default; a program
    traced on the CPU is moved to the card when it is loaded there).
    Returns the file's bytes."""
    staged = Sampler(cfg, state_dict, n_samples, scale_temperatures,
                     output_dtype, device=device, serve_dtype=serve_dtype)
    dev = staged.device
    shapes = decoder_noise_shapes(cfg, n_samples)
    t = torch.ones((n_samples,) if per_sample_temperature else (),
                   device=dev)
    eps = [torch.zeros(s, device=dev) for s in shapes]
    with torch.no_grad():
        ep = torch.export.export(_SamplerProgram(staged), (t, eps))
    # The example inputs would be saved with the program: the noise of a
    # whole batch (tens of MB at batch 144).  The loader draws its own.
    ep.example_inputs = None
    # Export checks each dtype conversion at run time with an
    # ``_assert_tensor_metadata`` node: hundreds a call, a host dispatch
    # each, on a graph whose dtypes the export fixed.
    assert_op = torch.ops.aten._assert_tensor_metadata.default
    for node in list(ep.graph.nodes):
        if node.op == "call_function" and node.target is assert_op:
            ep.graph.erase_node(node)
    ep.graph_module.recompile()
    meta = {
        "format": PROGRAM_FORMAT,
        "config": _config_dict(cfg),
        "batch": int(n_samples),
        "scale_temperatures": list(staged._st) if staged._st else None,
        "per_sample_temperature": bool(per_sample_temperature),
        "output_dtype": output_dtype,
        "serve_dtype": serve_dtype,
        "step": int(step),
        "noise_shapes": [list(s) for s in shapes],
        "device": str(dev),
        "op_nodes": op_nodes(ep),
        "torch": torch.__version__,
    }
    return save_program(path, ep, meta)


def load_artifact(path: str, device: DeviceLike = "cuda"):
    """The sampler of an artifact on ``device``: a
    :class:`~nvae_torch.serving_program.ProgramSampler` for an
    :func:`export_program` file, a :class:`Sampler` for an
    :func:`export_sampler` one.  Its ``artifact`` attribute holds the
    file's settings (batch, per-sample temperature, dtypes, step) and
    ``form``, ``"program"`` or ``"weights"``."""
    if is_program(path):
        return load_program(path, device)
    p = torch.load(path, map_location="cpu", weights_only=True)
    if p.get("format") != ARTIFACT_FORMAT:
        raise ValueError(f"{path}: not a {ARTIFACT_FORMAT} artifact")
    sd: Dict[str, Leaf] = dict(p["tensors"])
    for k, v in p["quantized"].items():
        sd[k] = QuantizedLeaf(v["q"], v["scale"],
                              getattr(torch, v["orig_dtype"]))
    sampler = Sampler(ModelConfig(**p["config"]), sd, p["n_samples"],
                      p["scale_temperatures"], p["output_dtype"],
                      device=device, serve_dtype=p["serve_dtype"])
    sampler.step = int(p["step"])
    sampler.artifact = {
        "path": path, "form": "weights", "batch": int(p["n_samples"]),
        "per_sample_temperature": bool(p["per_sample_temperature"]),
        "serve_dtype": p["serve_dtype"] or "float32",
        "output_dtype": p["output_dtype"] or "float32",
        "step": int(p["step"]), "bytes": os.path.getsize(path),
    }
    return sampler
