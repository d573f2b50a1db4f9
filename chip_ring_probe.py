#!/usr/bin/env python3
"""What holds the depthwise kernels and the SE gate back, on one NVIDIA GPU.

Run from the repository root (needs a CUDA card and ``nvcc``)::

    python3 chip_ring_probe.py

It builds variants of ``nvae_torch/kernels/csrc/depthwise5x5.cu`` next to
each other, into a temporary directory, and times each kernel (#1 thin
forward, #2 fused forward, #3 dx, #4 dW/db) at the path shapes (B=144, fp32,
CUDA-graph replay as in ``chip_smoke.py``), calling the C entry points
directly with the launch geometry of ``depthwise.geometry``:

- ``as_is``: the source as it is;
- ``no_copy``: the ring copies of x (dy for dx) are not issued, so the
  kernel computes on zeros: the time of everything but those loads;
- ``no_compute``: the items are skipped (nothing is stored): the time of the
  copy pipeline alone;
- ``regs80``: ``__launch_bounds__`` for 3 blocks per SM (up to 85 registers)
  instead of 4 (64).

First it prints each ring kernel's SASS instruction counts
(``cuobjdump -sass``); then ``as_is`` runs over a sweep of slots per pass G
and passes ahead P.

``python3 chip_ring_probe.py --bf16 [--parent ROOT] [--no-sweep]`` probes
the bf16 forward (#2, with swish and the shape's bias), dx (#3, with
swish') and dW/db (#4) at the path shapes, B=144, input sets over twice
the L2 as ``chip_smoke.py`` times them: the sliding-row kernel
(``dw5x5_bf16``) as it is, and without its copies (``no_copy``), its
compute (``no_compute``), its widening (``no_widen``: the fp32 ring is
never written), its stores (``no_store``: for dx also the swish'
epilogue), or all but the compute loop (``compute_only``: no copies,
widening, stores or barriers), and dx built for 3 blocks an SM at 256
threads (``dx_three_blocks``: up to 80 registers), beside its blocks an SM
as the card reports them; with ``--parent`` the bf16 dx of the tree at ROOT where it
is the row ring (a tree from before the sliding-row dx) the same way
(``as_is``, ``no_copy``: no dy copies, ``no_compute``, ``no_widen``:
staged rows never widened); then, unless ``--no-sweep``, ``as_is`` over a
sweep of G, P, chunks a block and batch rows a block (``--sweep dx``, or
``fused,dx,dw``: only those kernels' sweeps).

Then, the same way, variants of ``nvae_torch/kernels/csrc/se_gate.cu``
(kernel #5) at the model's four SE shapes at B=144, through its C entry with
``se_gate.geometry``:

- ``as_is``: the source as it is;
- ``no_exchange``: the cluster barriers become block barriers and no
  first-layer sum is sent or awaited (the other rows of ``hpart`` are left
  as they are): the time without the exchange;
- ``no_loads``: the pixel slice is not copied, so the block pools and
  gates whatever its shared memory holds: the time without reading x;
- ``no_store``: y is not written;
- ``empty``: the kernel returns at once: the launch alone;
- ``no_weights``: w1 and w2 are not copied;
- ``no_pool``: the pool's loop over the slice is skipped;
- ``no_dense``: both dense layers' products are skipped (the exchange
  still runs);
- ``skeleton``: ``no_exchange``, ``no_loads`` and ``no_store`` together.

``as_is`` and ``skeleton`` also run at other cluster and block sizes.

``python3 chip_ring_probe.py --se`` runs only the gate's part.  Prints one
line per measurement and, last, the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os
import re
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = [(4, 1536), (8, 768), (16, 384), (32, 192)]
BATCH = 144
# The row ring's variants (fp32 #1-#4; in a parent tree, also its bf16
# instances, which ran on the ring until the sliding-row kernel replaced
# them).
RING_NO_COPY = [("        copy_async(dst + px * kChunk + cl,",
                 "        if (W < 0) copy_async(dst + px * kChunk + cl,")]
RING_NO_COMPUTE = [("  auto compute = [&](const Cursor& cur) {\n"
                    "    if (!live) return;",
                    "  auto compute = [&](const Cursor& cur) {\n"
                    "    if (live) return;")]
# The sliding-row kernel's (bf16 #2-#4) variants.
SLIDE_NO_COPY = [("      if (row_in || x_in) {",
                  "      if ((row_in || x_in) && W < 0) {")]
SLIDE_NO_COMPUTE = [("  auto compute = [&](int q0) {\n",
                     "  auto compute = [&](int q0) {\n"
                     "    if (W > 0) return;\n")]
SLIDE_NO_WIDEN = [("          widen_copy<kOp>(xs +",
                   "          if (W < 0) widen_copy<kOp>(xs +")]
SLIDE_NO_STORE = [("            if (s >= kHalo) {  // output row s - 4 is "
                   "complete", "            if (s >= kHalo && W < 0) {")]
SLIDE_NO_SYNC = [("    __syncthreads();  // pass p widened for all; pass p - 1 "
                  "read by all\n", "")]
VARIANTS = {
    "as_is": [],
    "no_copy": RING_NO_COPY + SLIDE_NO_COPY,
    "no_compute": RING_NO_COMPUTE + SLIDE_NO_COMPUTE,
    "regs80": [("constexpr int kMinBlocks = 4;",
                "constexpr int kMinBlocks = 3;")],
    "no_widen": SLIDE_NO_WIDEN,
    "no_store": SLIDE_NO_STORE,
    # bf16 dx's 256-thread build for 3 blocks an SM (80 registers) in
    # place of 2 (128).
    "dx_three_blocks": [("  return threads != 256 ? 1 : kind == kFwd ? 3 : 2;",
                         "  return threads != 256 ? 1 : kind == kDw ? 2 : 3;")],
    # The compute loop alone, racing on rows that are neither copied nor
    # widened, with no stores and no barrier.
    "compute_only": (SLIDE_NO_COPY + SLIDE_NO_WIDEN + SLIDE_NO_STORE
                     + SLIDE_NO_SYNC),
}
# The parent's bf16 ring (bf16 dx in a tree from before the sliding-row
# dx): its staged rows widened by their copier.
PARENT_VARIANTS = {
    "as_is": [],
    "no_copy": RING_NO_COPY,
    "no_compute": RING_NO_COMPUTE,
    "no_widen": [("    if (kStaged) {\n      widen(cur);",
                  "    if (kStaged) {\n      if (W < 0) widen(cur);")],
}


SE_VARIANTS = {
    "as_is": [],
    "no_exchange": [
        ("        send_async(map_rank(smem_addr(own + j), r), s, "
         "map_rank(xbar, r));\n", ""),
        ("  if (k > 1) wait_parity0(xbar);\n", ""),
        ('asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: '
         '"memory");', "__syncthreads();"),
        ('asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: '
         '"memory");', ""),
    ],
    "no_loads": [("if (a.vec_in && t == 0) {", "if (a.vec_in && t < 0) {"),
                 ("if (a.vec_in) wait_parity0(bar);", ""),
                 ("if (!a.vec_in) {", "if (false) {")],
    "no_store": [("reinterpret_cast<float4*>(yr)[i] = v;",
                  "if (v.x == 1234.5f) reinterpret_cast<float4*>(yr)[i] = v;")],
}
SE_VARIANTS["empty"] = [
    ("  extern __shared__ __align__(16) unsigned char smem_raw[];\n",
     "  extern __shared__ __align__(16) unsigned char smem_raw[];\n"
     "  if (a.k > 0) return;\n")]
SE_VARIANTS["no_weights"] = [
    ("  for (int i = t; i < C * Hd; i += kThreads) copy4_async(w1s + i, "
     "a.w1 + i);\n", ""),
    ("  for (int i = t; i < Hd * C; i += kThreads) copy4_async(w2s + i, "
     "a.w2 + i);\n", "")]
SE_VARIANTS["no_pool"] = [
    ("    for (int col = t - g * W; col < W; col += kThreads) {",
     "    for (int col = t - g * W; col < 0; col += kThreads) {")]
# The exchange's loop stays: a block that sends nothing would leave the
# others waiting.
SE_VARIANTS["no_dense"] = [
    ("  for (int f = t; f < Q * Hd; f += kThreads) {",
     "  for (int f = t; f < 0; f += kThreads) {"),
    ("  for (int c = t; c < C; c += kThreads) {\n    const float* w = w2s",
     "  for (int c = t; c < 0; c += kThreads) {\n    const float* w = w2s")]
# All three at once: the launch, the weight copies and the arithmetic.
SE_VARIANTS["skeleton"] = (SE_VARIANTS["no_exchange"] + SE_VARIANTS["no_loads"]
                           + SE_VARIANTS["no_store"])


def compile_variants(tmp: str, source: str, variants: dict,
                     csrc: str = "", tag: str = "") -> dict:
    """Each variant of ``csrc/<source>`` (text substitutions) built into
    ``tmp``, one ``nvcc`` each, all started together; returns the loaded
    libraries by variant name.  ``csrc``: another tree's source directory
    (its files named with ``tag``)."""
    from nvae_torch.kernels import _build

    src = open(os.path.join(csrc or _build.CSRC_DIR, source)).read()
    stem = source.split(".")[0] + tag
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: source text not found")
            text = text.replace(old, new)
        path = os.path.join(tmp, f"{stem}_{name}")
        with open(f"{path}.cu", "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", f"{path}.so",
             f"{path}.cu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {stem} {name}:\n{out}")
        libs[name] = ctypes.CDLL(os.path.join(tmp, f"{stem}_{name}.so"))
    return libs


def build(tmp: str, variants=None, csrc: str = "", tag: str = "") -> dict:
    libs = compile_variants(tmp, "depthwise5x5.cu", variants or VARIANTS,
                            csrc, tag)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    geo = ctypes.POINTER(ctypes.c_int)
    for lib in libs.values():
        lib.nvae_dw5x5_fwd.argtypes = lib.nvae_dw5x5_fwd_bf16.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i64, i64, i64, i32, geo,
            i32, ptr]
        lib.nvae_dw5x5_dx.argtypes = lib.nvae_dw5x5_dx_bf16.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i64, i64, i64, geo, i32,
            ptr]
        lib.nvae_dw5x5_dw.argtypes = lib.nvae_dw5x5_dw_bf16.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, geo, i32,
            ptr]
    return libs


def se_probe(tmp: str, device) -> None:
    """Kernel #5's variants at the model's SE shapes, as ``chip_smoke.py``
    times the gate (input sets over twice the L2 cache)."""
    import chip_smoke as cs
    from nvae_torch.kernels import se_gate as se

    libs = compile_variants(tmp, "se_gate.cu", SE_VARIANTS)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.nvae_se_gate.argtypes = [ptr] * 6 + [i32] * 4 + [
            ctypes.POINTER(ctypes.c_int), i32, ptr]

    def call(lib, geo, x, w1, b1, w2, b2):
        y = torch.empty_like(x)
        err = lib.nvae_se_gate(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), y.data_ptr(), geo.batch, geo.hw, geo.c, geo.hd,
            geo.c_array(), 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"se_gate launch failed ({err})")

    for h, c, hd in cs.SE_SHAPES:
        n = BATCH * h * h * c
        n_sets = int(2 * cs.L2_BYTES // (4 * n)) + 1
        sets = [cs.se_inputs(BATCH, h, h, c, hd, device, seed=s)
                for s in range(n_sets)]
        geo = se.geometry(BATCH, h * h, c, hd)
        # The rule's (cluster size, threads), then the others.
        rule = (geo.cluster, geo.threads)
        for k, threads in dict.fromkeys((rule, (1, 256), (1, 128), (2, 128),
                                         (4, 128), (8, 128))):
            for name, lib in libs.items():
                if (k, threads) != rule and name not in ("as_is", "skeleton"):
                    continue
                alt = dataclasses.replace(
                    geo, cluster=k, threads=threads,
                    smem_bytes=se._smem_bytes(h * h, c, hd, k, threads))
                ms = cs.time_ms(lambda *a: call(lib, alt, *a), sets,
                                max(40, n_sets))[0]
                print(f"se_gate {BATCH}x{h}x{h}x{c} {name} k={k} "
                      f"threads={threads}: "
                      f"{ms * 1e3:.2f} us (resident clusters "
                      f"{se.max_active_clusters(alt)})", flush=True)
        del sets


def sass_counts(so_path: str) -> None:
    """Per ring kernel in ``so_path`` (``cuobjdump -sass``): its static
    instructions, FFMA and LDS, and the instructions of one item (from the
    first shared load before its first FFMA to the last global store after
    its last FFMA; the item's code appears once, fully unrolled)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    sass = subprocess.run([os.path.join(cuda_home, "bin", "cuobjdump"),
                           "-sass", so_path], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n")[0].strip()
        ops = [m.group(1) for m in re.finditer(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
            block)]
        fma = [i for i, op in enumerate(ops) if op.startswith("FFMA")]
        if not fma or not ("dw5x5_ring" in name or "dw5x5_bf16" in name):
            continue
        start = max((i for i in range(max(0, fma[0] - 80), fma[0])
                     if ops[i].startswith("LDS")), default=fma[0])
        end = max((i for i in range(fma[-1], min(len(ops), fma[-1] + 120))
                   if ops[i].startswith("STG")), default=fma[-1])
        count = lambda prefix: sum(op.startswith(prefix) for op in ops)
        print(f"sass {name[name.find('dw5x5_'):][:48]}: {len(ops)} "
              f"instructions, {count('FFMA')} FFMA, {count('LDS')} LDS; one "
              f"item {end - start + 1} instructions", flush=True)


def call(lib, kind, geo, x, k, g, bias=None):
    """One launch of kernel ``kind`` through the C entry, as the wrappers;
    bf16 ``x`` goes to the bf16 entries."""
    b, h, w, c = x.shape
    s = torch.cuda.current_stream().cuda_stream
    ga = geo.c_array()
    strides = (k.stride(0), k.stride(1), k.stride(3))
    bf16 = "_bf16" if x.dtype == torch.bfloat16 else ""
    if kind in ("thin", "fused"):
        y = torch.empty_like(x)
        err = getattr(lib, f"nvae_dw5x5_fwd{bf16}")(
            x.data_ptr(), k.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), b, h,
            w, c, *strides, int(kind == "fused"), ga, 0, s)
    elif kind == "dx":
        y = torch.empty_like(x)
        err = getattr(lib, f"nvae_dw5x5_dx{bf16}")(
            g.data_ptr(), k.data_ptr(), x.data_ptr(), y.data_ptr(), b, h, w,
            c, *strides, ga, 0, s)
    else:
        part = torch.empty(geo.blocks_per_chunk, 26, c, device=x.device)
        dk = torch.empty(25, c, device=x.device)
        db = torch.empty(c, device=x.device)
        err = getattr(lib, f"nvae_dw5x5_dw{bf16}")(
            x.data_ptr(), g.data_ptr(), part.data_ptr(), dk.data_ptr(),
            db.data_ptr(), b, h, w, c, geo.blocks_per_chunk, 1, ga, 0, s)
    if err:
        raise RuntimeError(f"{kind} launch failed ({err})")


def with_passes(geo, kind, shape, per_pass, ahead):
    """``geo`` with another (G, P), its blocks laid out as geometry() does;
    None where the ring does not fit a block."""
    from nvae_torch.kernels import depthwise as dw

    smem = dw._smem_bytes(kind, shape[2], per_pass, ahead)
    if smem > dw._MAX_SMEM:
        return None
    per_sm = min(dw._MIN_BLOCKS, dw._SM_SMEM // (smem + dw._BLOCK_RESERVED_SMEM))
    cap = min(shape[0], max(1, dw._SMS * per_sm // geo.chunks))
    rows = -(-shape[0] // cap)
    return dataclasses.replace(geo, slots_per_pass=per_pass, ahead=ahead,
                               smem_bytes=smem,
                               blocks_per_chunk=-(-shape[0] // rows))


def parent_geometry(root: str):
    """``geometry`` of the ``nvae_torch`` under ``root`` (another tree),
    loaded apart from this tree's module."""
    import importlib.util

    path = os.path.join(root, "nvae_torch", "kernels", "depthwise.py")
    spec = importlib.util.spec_from_file_location("parent_depthwise", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod.geometry


def slide_with(geo, kind, shape, per_pass, ahead, chunks_per_block,
               rows=None):
    """The sliding-row kernel's ``geo`` with another G, P, chunks a block and
    batch rows a block (default: laid out as geometry() does); None where
    it does not fit a block."""
    from nvae_torch.kernels import depthwise as dw

    b, _, w, c = shape
    strips = -(-w // dw._BF16_STRIP)
    threads = 32 * strips * chunks_per_block
    if threads > dw._BF16_MAX_THREADS or chunks_per_block > geo.chunks:
        return None
    smem = dw._bf16_smem_bytes(kind, w, per_pass, ahead, chunks_per_block)
    if smem > dw._MAX_SMEM:
        return None
    groups = -(-geo.chunks // chunks_per_block)
    if rows is None:
        build_ = 256 if threads <= 256 else 512 if threads <= 512 else 1024
        per_sm = min(dw._SM_REGS // (dw._BF16_REGS[kind][build_] * threads),
                     dw._SM_THREADS // threads, dw._SM_BLOCKS,
                     dw._SM_SMEM // (smem + dw._BLOCK_RESERVED_SMEM))
        parts = (dw._bf16_dw_parts(b, shape[1], w, c, groups,
                                   chunks_per_block, per_sm)
                 if kind == "dw" else dw._bf16_geometry(
                     kind, b, shape[1], w, c).blocks_per_chunk)
    else:
        parts = -(-b // rows)
    return dataclasses.replace(geo, slots_per_pass=per_pass, ahead=ahead,
                               smem_bytes=smem, threads=threads,
                               chunks_per_block=chunks_per_block,
                               blocks_per_chunk=parts)


def bf16_probe(tmp: str, device, parent: str,
               sweep=("fused", "dx", "dw")) -> None:
    """bf16 #2 (with swish and the shape's bias), #3 (with swish') and #4
    (with swish) at the path shapes, B=144: the sliding-row kernel's
    variants and, with ``parent``, the parent tree's bf16 dx ring's (see
    the module's doc); then, for the kernels in ``sweep``, the sliding
    kernel's G, P, chunks a block and batch rows a block.  Input sets hold
    more than twice the L2 of bf16 x, as chip_smoke.py's bf16 timing."""
    import chip_smoke as cs
    from nvae_torch.kernels import depthwise as dw

    names = ("as_is", "no_copy", "no_compute", "no_widen", "no_store",
             "compute_only", "dx_three_blocks")
    libs = build(tmp, {n: VARIANTS[n] for n in names})
    sass_counts(os.path.join(tmp, "depthwise5x5_as_is.so"))
    old = {}
    if parent:
        old = build(tmp, PARENT_VARIANTS,
                    os.path.join(parent, "nvae_torch", "kernels", "csrc"),
                    "_parent")
        old_geometry = parent_geometry(parent)
    for h, c, bias, _, _ in cs.PATH_SHAPES:
        shape = (BATCH, h, h, c)
        n = BATCH * h * h * c
        n_sets = int(2 * cs.L2_BYTES // (2 * n)) + 1
        sets = []
        for s in range(n_sets):
            x, k, b = cs.bf16_inputs(h, c, bias, device, seed=s)
            g = cs.bf16_inputs(h, c, False, device, seed=100 + s)[0]
            sets.append((x, k, g, b))
        iters = max(40, n_sets)
        for kind, gkind in (("fused", "fwd"), ("dx", "dx"), ("dw", "dw")):
            def timed(lib, geo):
                return cs.time_ms(lambda x, k, g, b: call(
                    lib, kind, geo, x, k, g, b if kind == "fused" else None),
                    sets, iters)[0] * 1e3

            geo = dw.geometry(gkind, shape, "bfloat16")
            occupancy = libs["as_is"].nvae_dw5x5_bf16_blocks_per_sm
            occupancy.argtypes = [ctypes.c_int] * 4
            per_sm = occupancy(cs.BF16_KIND_INDEX[gkind], geo.threads,
                               geo.smem_bytes, 0)
            print(f"bf16 {kind} {BATCH}x{h}x{h}x{c}: {per_sm} blocks an SM "
                  f"at {geo.threads} threads, {geo.smem_bytes} B", flush=True)
            for name, lib in libs.items():
                if name.startswith("dx_") and kind != "dx":
                    continue  # a variant of dx's build alone
                print(f"bf16 {kind} {BATCH}x{h}x{h}x{c} slide {name} "
                      f"G={geo.slots_per_pass} P={geo.ahead} "
                      f"K={geo.chunks_per_block} blocks={geo.blocks}: "
                      f"{timed(lib, geo):.1f} us", flush=True)
            if old and kind == "dx":
                ogeo = old_geometry(gkind, shape, "bfloat16")
                for name, lib in old.items():
                    print(f"bf16 {kind} {BATCH}x{h}x{h}x{c} ring {name} "
                          f"G={ogeo.slots_per_pass} P={ogeo.ahead} "
                          f"blocks={ogeo.blocks}: "
                          f"{timed(lib, ogeo):.1f} us", flush=True)
            seen = {geo}
            for per_pass in ((5, 10) if kind in sweep else ()):
                for ahead in (1, 2, 4):
                    for kpb in (1, 2, 4, 8):
                        for rows in (None, 1, 2, 3, 6):
                            alt = slide_with(geo, gkind, shape, per_pass,
                                             ahead, kpb, rows)
                            if alt is None or alt in seen:
                                continue
                            seen.add(alt)
                            print(f"bf16 {kind} {BATCH}x{h}x{h}x{c} sweep "
                                  f"G={per_pass} P={ahead} K={kpb} "
                                  f"rows={rows or 'rule'} "
                                  f"blocks={alt.blocks}: "
                                  f"{timed(libs['as_is'], alt):.1f} us",
                                  flush=True)
        del sets


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_ring_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    device = torch.device("cuda", 0)
    args = sys.argv[1:]
    parent = args[args.index("--parent") + 1] if "--parent" in args else ""
    with tempfile.TemporaryDirectory() as tmp:
        if "--bf16" in args:
            sweep = ("fused", "dx", "dw")
            if "--sweep" in args:
                sweep = tuple(args[args.index("--sweep") + 1].split(","))
            bf16_probe(tmp, device, os.path.abspath(parent) if parent else "",
                       () if "--no-sweep" in args else sweep)
        else:
            if "--se" not in args:
                ring_probe(tmp, device)
            se_probe(tmp, device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


def ring_probe(tmp: str, device) -> None:
    """Kernels #1-#4: SASS counts, the variants, and the (G, P) sweep."""
    import chip_smoke as cs
    from nvae_torch.kernels import depthwise as dw

    libs = build(tmp, {n: VARIANTS[n]
                       for n in ("as_is", "no_copy", "no_compute", "regs80")})
    sass_counts(os.path.join(tmp, "depthwise5x5_as_is.so"))
    for h, c in SHAPES:
        shape = (BATCH, h, h, c)
        n_sets = max(2, min(8, math.ceil(200e6 / (8 * BATCH * h * h * c))))
        sets = []
        for s in range(n_sets):
            x, k, _ = cs.path_inputs(h, c, False, device, seed=s)
            g = cs.path_inputs(h, c, False, device, seed=100 + s)[0]
            sets.append((x, k, g))
        for kind in ("thin", "fused", "dx", "dw"):
            gkind = "fwd" if kind in ("thin", "fused") else kind
            geo = dw.geometry(gkind, shape)
            for name, lib in libs.items():
                ms = cs.time_ms(lambda x, k, g: call(lib, kind, geo, x, k,
                                                     g), sets)[0]
                print(f"{kind} {BATCH}x{h}x{h}x{c} {name} "
                      f"G={geo.slots_per_pass} P={geo.ahead}: "
                      f"{ms * 1e3:.1f} us", flush=True)
            for per_pass in (2, 4, 6, 8, 12, 16, 24, 32):
                for ahead in (1, 2):
                    alt = with_passes(geo, gkind, shape, per_pass, ahead)
                    if alt is None or alt == geo:
                        continue
                    ms = cs.time_ms(lambda x, k, g: call(
                        libs["as_is"], kind, alt, x, k, g), sets)[0]
                    print(f"{kind} {BATCH}x{h}x{h}x{c} sweep G={per_pass}"
                          f" P={ahead} blocks={alt.blocks}: "
                          f"{ms * 1e3:.1f} us", flush=True)
        del sets


if __name__ == "__main__":
    sys.exit(main())
