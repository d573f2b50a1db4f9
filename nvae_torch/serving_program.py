"""The program form of the serving artifact, loaded and run without the
model code (counterpart of ``nvae_tpu/serving.py:load_artifact`` and the
``Exported.call`` its server makes).

:func:`nvae_torch.serving.export_program` writes the sampler as a
``torch.export`` program (``torch.export.save``): the graph of
``NVAE.sample`` at one batch, with the served weights (cast to bf16, or int8
``q`` and ``scale`` dequantized in the graph by one multiply each) as its
buffers, and the fused depthwise forward (#2) recorded as the op
``nvae_torch::fused_swish_dw5x5``.  A serving host needs this file, torch,
and ``nvae_torch.kernels`` (which registers the op and builds its CUDA
kernel at first use); this module imports nothing else of the port but
:mod:`nvae_torch.device`.

The program's inputs are ``(temperature, eps)``: an ``f32[]`` or
``f32[batch]`` temperature and the Gaussian draws of one ``NVAE.sample``
call, in its draw order (z0, one per group g >= 1, z1, z2), NHWC, whose
shapes the file's metadata lists (``noise_shapes``).  ``torch.export``
takes no ``torch.Generator``: :class:`ProgramSampler` draws them from
``torch.Generator(device).manual_seed(seed)`` in that order, so the caller's
convention stays ``(seed, temperature) -> images`` and a call gives the
weights-file :class:`~nvae_torch.serving.Sampler`'s images bitwise on one
device.  By hand, with only torch::

    import json, torch, nvae_torch.kernels
    extra = {"nvae_torch_sampler.json": ""}
    ep = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra["nvae_torch_sampler.json"])
    gen = torch.Generator("cuda").manual_seed(seed)
    eps = [torch.randn(s, generator=gen, device="cuda")
           for s in meta["noise_shapes"]]
    images = ep.module()(torch.tensor(0.8, device="cuda"), eps)

(an artifact exported on another device first goes through
``torch.export.passes.move_to_device_pass``), under the process-wide math
flags :func:`~nvae_torch.device.fp32_math` sets, which no graph holds.
"""

from __future__ import annotations

import json
import os
import threading
import warnings
import zipfile

import numpy as np
import torch

import nvae_torch.kernels  # noqa: F401  (registers #2's op)
from nvae_torch.device import DeviceLike, fp32_math, resolve_device

PROGRAM_FORMAT = "nvae_torch.sampler_program/1"
META_FILE = "nvae_torch_sampler.json"


def is_program(path: str) -> bool:
    """Whether ``path`` is a program artifact (a ``torch.export`` archive
    that carries the sampler's metadata)."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(os.path.basename(n) == META_FILE for n in z.namelist())


def read_meta(path: str) -> dict:
    """The metadata a program artifact was saved with."""
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            if os.path.basename(name) == META_FILE:
                meta = json.loads(z.read(name))
                break
        else:
            raise ValueError(f"{path}: not a {PROGRAM_FORMAT} artifact")
    if meta.get("format") != PROGRAM_FORMAT:
        raise ValueError(f"{path}: format {meta.get('format')!r}, not "
                         f"{PROGRAM_FORMAT}")
    return meta


def save_program(path: str, ep, meta: dict) -> int:
    """``torch.export.save`` of ``ep`` with ``meta`` beside it, written to a
    temporary name and moved into place.  Returns the file's bytes."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f, warnings.catch_warnings():
        # Saving a buffer that is not contiguous (the channels_last
        # weights) warns that it is not a whole storage; each buffer owns
        # its storage, which is written whole and read back with its strides.
        warnings.filterwarnings("ignore", message="No complete tensor found")
        torch.export.save(ep, f, extra_files={META_FILE: json.dumps(meta)})
    os.replace(tmp, path)
    return os.path.getsize(path)


def op_nodes(ep) -> int:
    """How many times the graph of ``ep`` calls #2's op."""
    op = torch.ops.nvae_torch.fused_swish_dw5x5.default
    return sum(1 for n in ep.graph.nodes
               if n.op == "call_function" and n.target is op)


class ProgramSampler:
    """A program artifact on ``device``, called as ``(seed, temperature) ->
    images`` like :class:`~nvae_torch.serving.Sampler`.

    ``temperature`` is a float or, for a per-sample artifact, an
    ``f32[batch]`` vector (a float fills it); on the CPU it reaches the card
    by a non-blocking copy.  The weights are the program's: there is no
    ``swap``; a server reloads by loading the file again.  ``artifact``
    holds the file's settings and ``"form": "program"``; ``info`` the
    record a server's ``/stats`` reports.  One thread calls at a time."""

    def __init__(self, path: str, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        meta = read_meta(path)
        with open(path, "rb") as f:  # any file name, not only *.pt2
            ep = torch.export.load(f)
        if torch.device(meta["device"]).type != self.device.type:
            from torch.export.passes import move_to_device_pass

            ep = move_to_device_pass(ep, self.device)
        self.program = ep
        self._fn = ep.module()
        self.meta = meta
        self.n_samples = int(meta["batch"])
        self.noise_shapes = [tuple(s) for s in meta["noise_shapes"]]
        self.per_sample = bool(meta["per_sample_temperature"])
        self.output_dtype = meta["output_dtype"]
        self.serve_dtype = meta["serve_dtype"]
        self.step = int(meta["step"])
        self.generation = 0
        self._calling = threading.Lock()
        self.artifact = {
            "path": path, "form": "program", "batch": self.n_samples,
            "per_sample_temperature": self.per_sample,
            "serve_dtype": self.serve_dtype or "float32",
            "output_dtype": self.output_dtype or "float32",
            "step": self.step, "bytes": os.path.getsize(path),
            "op_nodes": int(meta["op_nodes"]),
        }

    @property
    def weights_bytes(self) -> int:
        """Bytes of the program's weights on the device."""
        return sum(t.nbytes for t in self.program.state_dict.values())

    def _temperature(self, temperature) -> torch.Tensor:
        t = temperature
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.array(t, dtype=np.float32))
        t = t.to(torch.float32)
        if self.per_sample and t.dim() == 0:
            t = t.expand(self.n_samples).contiguous()
        want = (self.n_samples,) if self.per_sample else ()
        if tuple(t.shape) != want:
            raise ValueError(f"the program takes a temperature of shape "
                             f"{want}, got {tuple(t.shape)}")
        if t.device.type == "cpu" and self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def run(self, temperature, eps) -> torch.Tensor:
        """The program on given noise: ``eps`` the Gaussian draws in
        ``noise_shapes`` (tensors or arrays, fp32), as tests feed both
        packages the same noise."""
        t = self._temperature(temperature)
        eps = [(e if isinstance(e, torch.Tensor) else torch.from_numpy(
            np.array(e, dtype=np.float32))).to(self.device, torch.float32)
               for e in eps]
        if not self._calling.acquire(blocking=False):
            raise RuntimeError("a ProgramSampler is called from one thread "
                               "at a time (its dispatch thread)")
        try:
            with torch.inference_mode(), fp32_math(deterministic=True):
                return self._fn(t, eps)
        finally:
            self._calling.release()

    def __call__(self, seed: int, temperature) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return self.run(temperature, [
            torch.randn(s, generator=gen, device=self.device)
            for s in self.noise_shapes])

    @property
    def info(self) -> dict:
        return {
            "step": self.step,
            "generation": self.generation,
            "serve_dtype": self.serve_dtype or "float32",
            "output_dtype": self.output_dtype or "float32",
            "device": str(self.device),
            "form": "program",
        }


def load_program(path: str, device: DeviceLike = "cuda") -> ProgramSampler:
    """A :class:`ProgramSampler` of the program artifact at ``path``."""
    return ProgramSampler(path, device)
