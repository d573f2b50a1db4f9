"""Rematerialization (``remat=True``, the ``celeba64`` preset's switch)
against the JAX package's ``nn.remat`` cells, on the CPU at debug size.

JAX's remat recomputes a pure function: the BatchNorm running statistics
and the forward-mode spectral ``u`` move once a step.  The port's
``torch.utils.checkpoint`` runs each cell a second time in the backward
pass; these tests hold it to one update: against JAX's remat step (to the
tolerances of ``tests/test_torch_dml.py``'s step) and against the port's
own step without remat, which it must equal bit for bit (the same
operations on the same inputs).  Also: the recompute launches the fused
depthwise forward a second time, and the converter moves the Flax tree of
a remat model, whose compact cells Flax names ``Checkpoint<cell>_i``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvae_torch import config as tcfg
from nvae_torch.convert import flax_tree_from_state_dict, state_dict_from_flax
from nvae_torch.kernels import depthwise as tdw
from nvae_torch.models.nvae import NVAE as TorchNVAE
from nvae_torch.nn.blocks import BatchNorm
from nvae_torch.nn.spectral import SNConv
from nvae_torch.train.losses import recon_loss
from nvae_tpu import config as jcfg
from nvae_tpu.models import NVAE as JaxNVAE
from tests.test_torch_dml import DML, check_step, models, rgb_batch, run_steps
from tests.test_torch_sampler import random_flax_variables
from tests.test_torch_train_step import _max_err
from tests.test_torch_trainer import single_torch_thread

REMAT = dict(DML, remat=True, spectral_mode="forward")


@pytest.fixture(autouse=True)
def one_torch_thread():
    with single_torch_thread():
        yield


@pytest.fixture(scope="module")
def remat_steps():
    """Two SGD steps of the debug DML model with remat and forward-mode
    spectral normalization: JAX's, and the port's with and without remat
    from the same weights and noise."""
    with single_torch_thread():
        return run_steps(REMAT, 2, variants=({}, dict(remat=False)))[0]


def test_remat_step_matches_jax_remat_step(remat_steps):
    for i, (js, jmet, [(port, tmet), _]) in enumerate(remat_steps):
        assert js.spectral
        check_step(js, jmet, port, tmet, f"remat step {i}")


def test_remat_step_equals_the_step_without_remat(remat_steps):
    """The same step bit for bit: loss, parameters, BatchNorm statistics
    and ``u`` each moved once (a second update of the statistics would
    move them by ~5% of their distance to the batch's)."""
    for _, _, [(port, tmet), (plain, pmet)] in remat_steps:
        assert {k: float(v) for k, v in tmet.items()} == {
            k: float(v) for k, v in pmet.items()}
        for coll in ("params", "batch_stats", "spectral"):
            assert _max_err(port[coll], plain[coll])[0] == 0.0, coll


def test_recompute_relaunches_the_fused_forward_and_updates_no_buffer(
        monkeypatch):
    """One forward and backward of a remat model in training mode: the
    fused depthwise forward runs twice per depthwise layer (the second time
    in the recompute, as JAX re-runs the custom_vjp's forward), dx and
    dW/db once; the buffers end as without remat, every cell's
    ``update_buffers`` back on; under ``no_grad`` nothing is recomputed."""
    cfg = dict(REMAT, postprocess_5x5_depthwise=True)
    calls = {"forward": 0, "dx": 0}
    forward, dx = tdw._forward, tdw.fused_swish_depthwise5x5_dx

    def counted_forward(*args, **kwargs):
        calls["forward"] += 1
        return forward(*args, **kwargs)

    def counted_dx(*args, **kwargs):
        calls["dx"] += 1
        return dx(*args, **kwargs)

    monkeypatch.setattr(tdw, "_forward", counted_forward)
    monkeypatch.setattr(tdw, "fused_swish_depthwise5x5_dx", counted_dx)
    x = torch.from_numpy(rgb_batch(2, seed=6))
    ends = []
    for remat in (True, False):
        tm = TorchNVAE(tcfg.debug_config(**dict(cfg, remat=remat)),
                       device="cpu", seed=3)
        tm.train()
        calls.update(forward=0, dx=0)
        out = tm(x, generator=torch.Generator().manual_seed(1))
        recon_loss(out.logits, x, "dml", tm.cfg.n_mix).mean().backward()
        c = tm.cfg  # the generative cells and the postprocess nodes
        n = ((c.n_total_groups - 1) * c.res_cells_per_group
             + c.n_postprocess_blocks * c.n_postprocess_cells)
        assert calls == {"forward": 2 * n if remat else n, "dx": n}
        ends.append((tm.state_dict(), {k: p.grad for k, p in
                                       tm.named_parameters()}))
        assert all(m.update_buffers for m in tm.modules()
                   if isinstance(m, (BatchNorm, SNConv)))
    (sd_a, g_a), (sd_b, g_b) = ends
    for k in sd_b:
        assert torch.equal(sd_a[k], sd_b[k]), k
    for k in g_b:
        assert torch.equal(g_a[k], g_b[k]), k
    calls.update(forward=0)
    with torch.no_grad():
        TorchNVAE(tcfg.debug_config(**cfg), device="cpu")(
            x, generator=torch.Generator().manual_seed(1))
    assert calls["forward"] == n


def test_converter_round_trips_a_remat_tree():
    """The JAX remat model's Flax tree (compact cells named
    ``CheckpointStemCell_i``, ``CheckpointEncoderResidualCell_i``,
    ``CheckpointPostprocessCell_i``; the decoder's ``cells_i_j`` as
    without remat) fills every port tensor once and comes back unchanged;
    the same tree without remat raises on the first unknown leaf."""
    jm, variables, tm = models(REMAT, seed=5)
    flat = {n for tree in variables.values()
            for part in ("preprocess", "encoder", "postprocess")
            for n in tree.get(part, {})}
    for stem in ("CheckpointStemCell_0", "CheckpointEncoderResidualCell_0",
                 "CheckpointPostprocessCell_0"):
        assert stem in flat
    assert not any(n.startswith(("StemCell", "EncoderResidualCell",
                                 "PostprocessCell")) for n in flat)
    assert "cells_1_0" in variables["params"]["decoder"]
    back = flax_tree_from_state_dict(tm.state_dict(), tm)
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert len(jax.tree_util.tree_leaves(back)) == len(want)
    assert _max_err(back, variables)[0] == 0.0
    plain = random_flax_variables(
        JaxNVAE(jcfg.debug_config(**dict(REMAT, remat=False))), seed=5)
    with pytest.raises(KeyError, match="unknown Flax leaf"):
        state_dict_from_flax(plain, tm)
    assert jnp.asarray(back["params"]["postprocess"]["SNConv_0"][
        "sn_kernel"]).shape[-1] == 4 * 7
    np.testing.assert_array_equal(
        back["params"]["postprocess"]["SNConv_0"]["bias"],
        variables["params"]["postprocess"]["SNConv_0"]["bias"])
