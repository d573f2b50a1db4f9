"""The metric suite's row sharding (``mesh=``) on the CPU: the port's
``extract_features`` and k-NN precision/recall at world 2 against the
single rank and against the JAX package's ``mesh=`` results over a 2-device
data mesh (twin of ``tests/test_parallel.py::
test_sharded_precision_recall_matches_single_device``).

A world of two gloo ranks (``tests/test_torch_dist_worker.py``, one per
module) runs the port's side; this process runs JAX's meanwhile.  Row
counts that do not split over the ranks (37 images in batches of 16, 203
real and 157 generated feature rows) exercise the zero padding.

Tolerances: the world-2 features equal the single rank's bit for bit (each
image's convolutions do not depend on the batch on the CPU); against JAX's
features, relative L2 1e-4 of the feature norm (``tests/
test_torch_metrics.py``'s backbone limit).  Precision and recall equal the
single rank's exactly, and JAX's within 1e-6 (JAX's own limit between its
sharded and single runs); realism at rtol 1e-5 and the nearest neighbours
exactly, against both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvae_torch.convert import backbone_state_dict_from_flax
from nvae_tpu.eval import features as jfeat
from nvae_tpu.eval.precision_recall import (
    knn_precision_recall_features as jax_pr,
)
from nvae_tpu.parallel import make_mesh as jax_make_mesh
from tests.test_torch_dist_worker import spawn_world
from tests.test_torch_metrics import _flax_variables, _rel_l2

FEATURE_RTOL = 1e-4
FEATURE_BATCH = 16
PR_CASES = {
    "k3": dict(nhood_sizes=(3,)),
    "k3_k5": dict(nhood_sizes=(3, 5)),
    "streamed": dict(nhood_sizes=(3,), row_batch_size=64),
    "realism": dict(nhood_sizes=(3, 5), return_realism=True,
                    return_neighbors=True),
}
KEYS = ("precision", "recall", "precision_k3", "recall_k3")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.RandomState(0)
    images = rng.rand(37, 32, 32, 1).astype(np.float32)
    real = rng.randn(203, 32).astype(np.float32)
    gen = (rng.randn(157, 32) * 0.8 + 0.3).astype(np.float32)
    v = _flax_variables(jfeat._RandomConvNet(), 64, seed=0)
    world = spawn_world(
        tmp_path_factory.mktemp("eval_world"), ["eval"],
        {"images": images, "real": real, "gen": gen,
         "feature_batch": FEATURE_BATCH, "pr_cases": PR_CASES,
         "random_conv": backbone_state_dict_from_flax("random_conv", v)})
    try:
        mesh = jax_make_mesh(n_data=2, devices=jax.devices()[:2])
        extractor = jfeat.get_extractor("random_conv", input_size=64)
        want = {"features": np.asarray(jfeat.extract_features(
            images, extractor, batch_size=FEATURE_BATCH, mesh=mesh))}
        for case, kw in PR_CASES.items():
            want[case] = jax_pr(real, gen, mesh=mesh, **kw)
    except BaseException:
        world.kill()
        raise
    r0, r1 = world.results()
    return r0["eval"], r1["eval"], want


def test_sharded_features_match_single_rank_and_jax(results):
    r0, r1, want = results
    got = r0["mesh"]["features"]
    assert got.shape == (37, 512)
    np.testing.assert_array_equal(got, r0["single"]["features"])
    np.testing.assert_array_equal(got, r1["mesh"]["features"])
    assert _rel_l2(got, want["features"]) <= FEATURE_RTOL


@pytest.mark.parametrize("case", list(PR_CASES))
def test_sharded_precision_recall_matches_single_rank_and_jax(results, case):
    r0, r1, want = results
    got, single, jax_ = (r0["mesh"][case], r0["single"][case], want[case])
    assert r1["mesh"][case].keys() == got.keys() == single.keys()
    for k in KEYS:
        assert got[k] == single[k] == r1["mesh"][case][k]
        np.testing.assert_allclose(got[k], float(jax_[k]), atol=1e-6,
                                   err_msg=f"{case} {k}")
    assert 0.0 < got["precision"] < 1.0  # the manifolds partly overlap
    if "realism" in got:
        np.testing.assert_allclose(got["realism"], single["realism"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["realism"],
                                   np.asarray(jax_["realism"]), rtol=1e-5)
        np.testing.assert_array_equal(got["nearest_neighbors"],
                                      single["nearest_neighbors"])
        np.testing.assert_array_equal(got["nearest_neighbors"],
                                      np.asarray(jax_["nearest_neighbors"]))
