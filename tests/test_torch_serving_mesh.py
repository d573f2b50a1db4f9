"""The port's data-parallel sampler (``nvae_torch.serving.
build_mesh_sampler``) on the CPU: twins of ``tests/test_serving_mesh.py``.

A world of two gloo ranks (``tests/test_torch_dist_worker.py``, one per
module) serves the debug model at batch 8: rank 0 drives, rank 1 follows.
The mesh sampler must serve the single-device sampler's bytes for the same
``(seed, temperature)``: each rank draws the global batch's noise and keeps
its rows, so the draws do not depend on the rank count, and the dynamic
batching server's replay guarantee survives the split.  Held bit for bit
here (each row's arithmetic on the CPU does not depend on the batch size).
"""

import numpy as np
import pytest
import torch

from nvae_torch import debug_config
from nvae_torch.models.nvae import NVAE
from nvae_torch.parallel import DataMesh
from nvae_torch.serving import build_mesh_sampler
from tests.test_torch_dist_worker import SERVE_BATCH, spawn_world


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    r0, r1 = spawn_world(tmp_path_factory.mktemp("serve_world"),
                         ["serve"]).results()
    return r0["serve"], r1["serve"]


def test_mesh_sampler_bitwise_matches_single_device(served):
    out, follower = served
    assert out["scalar"].shape == (SERVE_BATCH, 32, 32, 1)
    assert torch.equal(out["scalar"], out["single"]["scalar"])
    assert out["info"]["ranks"] == 2
    # The follower sampled its rows of every call rank 0 made.
    assert follower["followed"] == 4


def test_mesh_sampler_per_sample_temperature(served):
    out, _ = served
    assert torch.equal(out["vector"], out["single"]["vector"])
    assert not torch.equal(out["vector"], out["scalar"])


def test_mesh_sampler_rejects_indivisible_batch():
    cfg = debug_config()
    sd = NVAE(cfg, device="cpu", seed=0).state_dict()
    mesh = DataMesh(rank=0, size=4, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        build_mesh_sampler(cfg, sd, 6, mesh)


def test_batching_runtime_over_mesh_sampler(served):
    """The dynamic-batching server runs unchanged over the mesh sampler on
    rank 0, and its served rows replay bit for bit against a direct call
    of the dispatch, and against the single-device sampler."""
    out, _ = served
    a, b = out["served"]
    direct = out["direct"].numpy()
    np.testing.assert_array_equal(a, direct[:5])
    np.testing.assert_array_equal(b, direct[5:])
    assert torch.equal(out["direct"], out["single"]["direct"])
    assert out["stats"] == (1, 1.0)
