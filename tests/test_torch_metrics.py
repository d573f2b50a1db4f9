"""The port's metric functions, feature backbones and image reader against
the JAX package's on the CPU, on the same numpy inputs and the same
weights (Flax trees carried across by
``nvae_torch.convert.backbone_state_dict_from_flax``).

Tolerances, each named where it is used:

- ``slerp`` / ``normalize_l2``: atol 1e-6 (unit vectors in fp32);
- ``pairwise_sq_dists``: rtol 1e-5 of the largest distance;
- k-NN membership and precision/recall values exactly equal (the radii
  and the memberships come from one package's own distances, so a flip
  needs a sample within an ulp of a sphere's boundary); realism at rtol
  1e-5; radii at rtol 1e-5;
- ``frechet_distance`` (fp32, two ``eigh``): rtol 1e-3 against JAX's, as
  two LAPACK eigensolvers in fp32 round differently (the JAX package holds
  its own at rtol 2e-2 against scipy); ``fid_from_features`` (fp64):
  rtol 1e-9;
- ``ppl.evaluate``: exactly equal (the same numpy code);
- each backbone's features: relative L2 <= 1e-4 of the feature norm;
- the resize paths: atol 2e-6 (the two libraries compute the bilinear
  weights in other orders: up to 1.3e-6 apart at 32 -> 299, about 20 fp32
  ulps of a pixel in [0, 1]; nearest is exact).
"""

import io
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvae_torch.convert import backbone_state_dict_from_flax
from nvae_torch.eval import features as tfeat
from nvae_torch.eval import frechet as tfre
from nvae_torch.eval import ppl as tppl
from nvae_torch.eval import precision_recall as tpr
from nvae_torch.ops.math import normalize_l2, slerp
from nvae_torch.utils import images as timg
from nvae_tpu.eval import features as jfeat
from nvae_tpu.eval import frechet as jfre
from nvae_tpu.eval import ppl as jppl
from nvae_tpu.eval import precision_recall as jpr
from nvae_tpu.eval.inception import InceptionV3Features as JaxInception
from nvae_tpu.ops import math as jmath
from tests.test_torch_trainer import single_torch_thread

CPU = "cpu"
FEATURE_RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    with single_torch_thread():
        yield


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---- ops -------------------------------------------------------------------


def test_slerp_and_normalize_l2_match_jax():
    rng = np.random.RandomState(0)
    a = rng.randn(5, 4, 4, 8).astype(np.float32)
    b = rng.randn(5, 4, 4, 8).astype(np.float32)
    t = rng.rand(5).astype(np.float32)
    np.testing.assert_allclose(normalize_l2(_t(a)).numpy(),
                               np.asarray(jmath.normalize_l2(a)), atol=1e-6)
    np.testing.assert_allclose(normalize_l2(_t(a), dim=0, eps=0.5).numpy(),
                               np.asarray(jmath.normalize_l2(a, 0, 0.5)),
                               atol=1e-6)
    np.testing.assert_allclose(slerp(_t(a), _t(b), _t(t)).numpy(),
                               np.asarray(jmath.slerp(a, b, t)), atol=1e-6)


# ---- Frechet ---------------------------------------------------------------


def test_frechet_matches_jax():
    rng = np.random.RandomState(0)
    a = rng.randn(200, 16).astype(np.float32)
    b = (rng.randn(220, 16) * 1.5 + 0.3).astype(np.float32)
    mu1, c1 = tfre.activation_statistics(_t(a))
    mu2, c2 = tfre.activation_statistics(_t(b))
    jmu1, jc1 = jfre.activation_statistics(jnp.asarray(a))
    jmu2, jc2 = jfre.activation_statistics(jnp.asarray(b))
    np.testing.assert_allclose(mu1.numpy(), np.asarray(jmu1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(c1.numpy(), np.asarray(jc1), rtol=1e-5,
                               atol=1e-6)
    got = float(tfre.frechet_distance(mu1, c1, mu2, c2))
    want = float(jfre.frechet_distance(jmu1, jc1, jmu2, jc2))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    np.testing.assert_allclose(
        tfre.fid_from_features(a, b, precise=False, device=CPU),
        jfre.fid_from_features(a, b, precise=False), rtol=1e-3)
    np.testing.assert_allclose(tfre.fid_from_features(a, b),
                               jfre.fid_from_features(a, b), rtol=1e-9)


def test_frechet_identical_and_separated():
    rng = np.random.RandomState(1)
    a = rng.randn(500, 8).astype(np.float32)
    assert tfre.fid_from_features(a, a.copy()) < 1e-6
    assert tfre.fid_from_features(a, a.copy(), precise=False,
                                  device=CPU) < 0.05
    b = rng.randn(300, 8).astype(np.float32) + 5.0
    assert 150 < tfre.fid_from_features(a, b) < 260


# ---- precision / recall ----------------------------------------------------


def test_pairwise_sq_dists_match_jax_and_numpy():
    rng = np.random.RandomState(3)
    u = rng.randn(10, 4).astype(np.float32)
    v = rng.randn(12, 4).astype(np.float32)
    got = tpr.pairwise_sq_dists(_t(u), _t(v)).numpy()
    want = np.asarray(jpr.pairwise_sq_dists(jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())
    np.testing.assert_allclose(got, ((u[:, None] - v[None]) ** 2).sum(-1),
                               rtol=1e-3, atol=1e-3)
    assert (tpr.pairwise_sq_dists(_t(u), _t(u)).numpy() >= 0).all()


def _pr_both(real, gen, **kw):
    port = tpr.knn_precision_recall_features(real, gen, device=CPU, **kw)
    ref = jpr.knn_precision_recall_features(real, gen, **kw)
    return port, ref


PR_CASES = {
    "full": dict(),
    "streamed_uneven": dict(row_batch_size=32),
    "multi_k": dict(nhood_sizes=(3, 5)),
    "multi_k_streamed": dict(nhood_sizes=(3, 5), row_batch_size=32),
    "clamp": dict(clamp_to_percentile=50.0),
    "realism_neighbors": dict(return_realism=True, return_neighbors=True),
    "realism_neighbors_streamed": dict(nhood_sizes=(3, 4), row_batch_size=32,
                                       return_realism=True,
                                       return_neighbors=True),
}


@pytest.mark.parametrize("case", sorted(PR_CASES))
def test_knn_precision_recall_matches_jax(case):
    """Every key equal to JAX's: the P&R values exactly, realism at rtol
    1e-5, the neighbour indices exactly; 70 and 58 rows make the last row
    and column blocks ragged in the streamed cases."""
    rng = np.random.RandomState(8)
    real = rng.randn(70, 8).astype(np.float32)
    gen = (rng.randn(58, 8) * 0.8 + 0.2).astype(np.float32)
    port, ref = _pr_both(real, gen, **PR_CASES[case])
    assert set(port) == set(ref)
    for k, v in ref.items():
        if k == "realism":
            np.testing.assert_allclose(port[k], v, rtol=1e-5)
        elif k == "nearest_neighbors":
            assert port[k].dtype == np.int32
            np.testing.assert_array_equal(port[k], v)
        else:
            assert port[k] == v, (k, port[k], v)
    assert 0.0 < port["precision"] < 1.0 and 0.0 < port["recall"] < 1.0


def test_identical_disjoint_and_subset_sets():
    rng = np.random.RandomState(4)
    feats = rng.randn(200, 16).astype(np.float32)
    pr = tpr.knn_precision_recall_features(feats, feats.copy(), device=CPU)
    assert pr["precision"] == 1.0 and pr["recall"] == 1.0
    far = rng.randn(200, 16).astype(np.float32) + 100.0
    pr = tpr.knn_precision_recall_features(feats, far, device=CPU)
    assert pr["precision"] == 0.0 and pr["recall"] == 0.0
    real = rng.randn(400, 8).astype(np.float32) * 3
    gen = rng.randn(400, 8).astype(np.float32) * 0.3
    pr = tpr.knn_precision_recall_features(real, gen, device=CPU)
    assert pr["precision"] > 0.8 and pr["recall"] < 0.5


@pytest.mark.parametrize("n", [64, 70])
def test_streamed_radii_match_full_and_jax(n):
    rng = np.random.RandomState(7)
    feats = rng.randn(n, 16).astype(np.float32)
    for k in (3, 5):
        full = tpr._knn_radii(_t(feats), k).numpy()
        streamed = tpr._knn_radii_batched(_t(feats), k, 32).numpy()
        np.testing.assert_allclose(streamed, full, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            full, np.asarray(jpr._knn_radii(jnp.asarray(feats), k)),
            rtol=1e-5)


def test_streamed_membership_matches_full_and_jax():
    rng = np.random.RandomState(9)
    ref = rng.randn(96, 16).astype(np.float32)
    ev = rng.randn(40, 16).astype(np.float32)
    radii = rng.rand(96).astype(np.float32) * 20.0
    full = tpr._membership(_t(ev), _t(ref), _t(radii)).numpy()
    for col in (32, 40):  # even and ragged column blocks
        np.testing.assert_array_equal(
            tpr._membership_rows(_t(ev), _t(ref), _t(radii), col).numpy(),
            full)
    np.testing.assert_array_equal(
        full, np.asarray(jpr._membership(ev, ref, radii)))


def _np_manifold_oracle(ref, ev, nhood_sizes, clamp=None, eps=1e-5):
    """NumPy transliteration of the reference's ``ManifoldEstimator``."""
    d_ref = ((ref[:, None] - ref[None]) ** 2).sum(-1)
    D = np.sort(d_ref, axis=1)[:, list(nhood_sizes)]
    if clamp is not None:
        D[D > np.percentile(D, clamp, axis=0)] = 0
    d = ((ev[:, None] - ref[None]) ** 2).sum(-1)
    preds = np.any(d[:, :, None] <= D[None, :, :], axis=1).astype(np.int32)
    return preds, np.max(D[:, 0] / (d + eps), axis=1), np.argmin(d, axis=1)


@pytest.mark.parametrize("rows,row_batch,ks", [
    (50, 10000, (3, 5)),  # one full tile
    (70, 32, (3,)),  # streamed, ragged final blocks
])
def test_manifold_evaluate_matches_oracle_and_jax(rows, row_batch, ks):
    rng = np.random.RandomState(11)
    ref = rng.randn(rows, 8).astype(np.float32)
    ev = (rng.randn(45, 8) * 0.8 + 0.2).astype(np.float32)
    est = tpr.ManifoldEstimator(ref, nhood_sizes=ks, row_batch_size=row_batch,
                                device=CPU)
    preds, realism, neighbors = est.evaluate(ev, return_realism=True,
                                             return_neighbors=True)
    want_p, want_r, want_n = _np_manifold_oracle(ref, ev, ks)
    np.testing.assert_array_equal(preds.numpy(), want_p)
    np.testing.assert_allclose(realism.numpy(), want_r, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(neighbors.numpy(), want_n)
    jest = jpr.ManifoldEstimator(ref, nhood_sizes=ks, row_batch_size=row_batch)
    jp, jr, jn = jest.evaluate(ev, return_realism=True, return_neighbors=True)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(jp))
    np.testing.assert_allclose(realism.numpy(), np.asarray(jr), rtol=1e-5)
    np.testing.assert_array_equal(neighbors.numpy(), np.asarray(jn))
    assert est.evaluate(ev).dtype == torch.int32
    _, only_n = est.evaluate(ev, return_neighbors=True)
    np.testing.assert_array_equal(only_n.numpy(), want_n)


def test_nearest_neighbour_ties_go_to_the_earlier_block():
    """Two reference rows at the same distance, in different column
    blocks: the first wins, as ``np.argmin`` picks it."""
    ref = np.zeros((6, 2), np.float32)
    ref[:, 0] = [5, 1, 7, 8, 1, 9]  # rows 1 and 4 tie for the origin
    est = tpr.ManifoldEstimator(ref, nhood_sizes=(1,), row_batch_size=3,
                                device=CPU)
    _, nn_idx = est.evaluate(np.zeros((1, 2), np.float32),
                             return_neighbors=True)
    assert nn_idx.tolist() == [1]


def test_clamp_to_percentile_matches_oracle_and_jax():
    rng = np.random.RandomState(13)
    ref = rng.randn(60, 8).astype(np.float32)
    ev = (rng.randn(30, 8) * 0.8).astype(np.float32)
    est = tpr.ManifoldEstimator(ref, nhood_sizes=(3,),
                                clamp_to_percentile=50.0, device=CPU)
    radii = est.radii[3].numpy()
    assert (radii == 0).sum() == pytest.approx(30, abs=2)
    jest = jpr.ManifoldEstimator(ref, nhood_sizes=(3,),
                                 clamp_to_percentile=50.0)
    np.testing.assert_allclose(radii, np.asarray(jest.radii[3]), rtol=1e-5)
    want_p, _, _ = _np_manifold_oracle(ref, ev, (3,), clamp=50.0)
    np.testing.assert_array_equal(est.evaluate(ev).numpy(), want_p)


def test_precision_recall_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((8, 4), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpr.knn_precision_recall_features(x, x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfre.fid_from_features(x, x, precise=False)


# ---- PPL -------------------------------------------------------------------


@pytest.mark.parametrize("per_sample", [False, True])
def test_ppl_evaluate_equals_jax(per_sample):
    rng = np.random.RandomState(7)
    act = rng.randn(64, 32).astype(np.float32)
    other = act + rng.randn(64, 32).astype(np.float32) * 1e-3
    assert (tppl.evaluate(act, other, per_sample=per_sample)
            == jppl.evaluate(act, other, per_sample=per_sample))
    assert (tppl.evaluate(act, act + 1e-3, per_sample=per_sample)
            > tppl.evaluate(act, act + 1e-5, per_sample=per_sample) > 0)


def test_slerp_pair_with_injected_t_matches_jax():
    rng = np.random.RandomState(2)
    z1 = rng.randn(6, 4, 4, 8).astype(np.float32)
    z2 = rng.randn(6, 4, 4, 8).astype(np.float32)
    t = rng.rand(6).astype(np.float32)
    a, b = tppl.slerp_pair(_t(z1), _t(z2), t=_t(t))
    np.testing.assert_allclose(a.numpy(), np.asarray(jmath.slerp(z1, z2, t)),
                               atol=1e-6)
    np.testing.assert_allclose(
        b.numpy(), np.asarray(jmath.slerp(z1, z2, t + 1e-4)), atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    a2, b2 = tppl.slerp_pair(_t(z1), _t(z2), gen)
    d = float((a2 - b2).abs().max())
    assert a2.shape == z1.shape and 0 < d < 0.1


# ---- backbones -------------------------------------------------------------


def _flax_variables(net, size, seed, randomize_bn=False):
    v = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))
    v = jax.tree_util.tree_map(np.asarray, v)
    if randomize_bn:  # non-trivial frozen BatchNorm statistics
        rng = np.random.RandomState(seed)

        def fix(path, a):
            name = path[-1].key
            if name == "bn_var":
                return (rng.rand(*a.shape) + 0.5).astype(np.float32)
            if name in ("bn_mean", "bn_beta"):
                return (rng.randn(*a.shape) * 0.1).astype(np.float32)
            return a

        v = jax.tree_util.tree_map_with_path(fix, v)
    return v


def _write_npz(path, params):
    flat = {}

    def walk(node, prefix):
        for k, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = val

    walk(params, "")
    np.savez(path, **flat)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# (name, Flax module, input size of the test)
BACKBONES = {
    "vgg16": (jfeat._VGG16Features, 48),
    "inception": (JaxInception, 96),
}


@pytest.fixture(scope="module", params=sorted(BACKBONES))
def backbone_npz(request, tmp_path_factory):
    """One Flax init per backbone, written as a ``.npz`` of Flax paths, and
    JAX's extractor over it (one compile per backbone for the module)."""
    name = request.param
    cls, size = BACKBONES[name]
    params = _flax_variables(cls(), size, seed=5,
                             randomize_bn=name == "inception")["params"]
    path = str(tmp_path_factory.mktemp(name) / f"{name}.npz")
    _write_npz(path, params)
    jax_fn = jfeat.get_extractor(name, input_size=size, weights_path=path)
    return name, size, path, params, jax_fn


def test_backbone_matches_flax_through_npz(backbone_npz):
    """Both packages load the same ``.npz``; the port's extractor (grey ->
    RGB, bilinear upsampling, [-1, 1] scaling, the backbone) against JAX's
    on the same images, relative L2 <= 1e-4."""
    name, size, path, params, jax_fn = backbone_npz
    images = np.random.RandomState(0).rand(3, 32, 32, 1).astype(np.float32)
    want = np.asarray(jax_fn(jnp.asarray(images)))
    port = tfeat.get_extractor(name, input_size=size, weights_path=path,
                               device=CPU)
    assert port.weights == "imagenet" and port.size == size
    got = tfeat.extract_features(images, port, batch_size=2)
    assert got.shape == want.shape == (3, 512 if name == "vgg16" else 2048)
    assert _rel_l2(got, want) <= FEATURE_RTOL
    # The Flax tree itself converts to the same state_dict.
    sd = backbone_state_dict_from_flax(name, {"params": params})
    for k, v in sd.items():
        assert torch.equal(v, port.net.state_dict()[k]), k


def test_backbone_convert_raises_on_a_stray_or_missing_leaf(backbone_npz):
    name, _, _, params, _ = backbone_npz
    first = sorted(params)[0]
    stray = dict(params, extra_layer={"kernel": np.zeros((1, 1, 3, 3))})
    with pytest.raises(KeyError, match="unknown Flax leaf"):
        backbone_state_dict_from_flax(name, stray)
    short = {k: v for k, v in params.items() if k != first}
    with pytest.raises(KeyError, match="not filled"):
        backbone_state_dict_from_flax(name, short)


@pytest.fixture(scope="module")
def random_conv_weights():
    """The JAX package's random_conv weights (its fixed PRNGKey(0) init)
    in the port's layout."""
    v = _flax_variables(jfeat._RandomConvNet(), 64, seed=0)
    net = tfeat.backbone_module("random_conv")
    net.load_state_dict(backbone_state_dict_from_flax("random_conv", v))
    return net


@pytest.mark.parametrize("size,method,scaling", [
    (64, "bilinear", "pm1"),  # upsampling
    (20, "bilinear", "unit"),  # downsampling, antialiased
    (48, "nearest", "pm1"),
    (20, "nearest", "unit"),
])
def test_random_conv_extractor_matches_jax(random_conv_weights, size, method,
                                           scaling):
    images = np.random.RandomState(1).rand(4, 32, 32, 1).astype(np.float32)
    want = np.asarray(jfeat.get_extractor(
        "random_conv", input_size=size, resize_method=method,
        input_scaling=scaling)(jnp.asarray(images)))
    port = tfeat.Extractor("random_conv", random_conv_weights, size, method,
                           scaling, torch.device(CPU), "fixed-seed")
    got = tfeat.extract_features(images, port)
    assert got.shape == (4, 512)
    assert _rel_l2(got, want) <= FEATURE_RTOL


@pytest.mark.parametrize("size", [20, 48, 224, 299])
@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_matches_jax(size, method, channels):
    x = np.random.RandomState(size).rand(2, 32, 32, channels).astype(
        np.float32)
    want = np.asarray(jfeat._resize_to(jnp.asarray(x), size, method))
    got = tfeat._resize_to(_t(x).permute(0, 3, 1, 2), size, method)
    assert got.shape == (2, 3, size, size)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=2e-6 if method == "bilinear"
                               else 0)


def test_extractor_options_are_checked():
    with pytest.raises(ValueError, match="input_scaling"):
        tfeat.get_extractor("random_conv", input_scaling="imagenet",
                            device=CPU)
    with pytest.raises(ValueError, match="resize method"):
        tfeat.get_extractor("random_conv", resize_method="cubic", device=CPU)
    with pytest.raises(ValueError, match="unknown feature extractor"):
        tfeat.get_extractor("resnet", device=CPU)


def test_random_init_without_weights(monkeypatch, tmp_path, capsys):
    """No weights file: the documented fixed-seed init (seeds 0 / 16 /
    299), LeCun-normal kernels, JAX's warning text, ``random-init``."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("NVAE_TPU_WEIGHTS", str(tmp_path / "none"))
    tfeat._cached_extractor.cache_clear()
    ex = tfeat.get_extractor("vgg16", input_size=32, device=CPU)
    out = capsys.readouterr().out
    assert ("WARNING: no local vgg16.npz found — using fixed-seed random "
            "VGG16 features. Metric values are self-consistent but not "
            "comparable to published numbers.") in out
    assert ex.weights == "random-init"
    again = tfeat.flax_init_(tfeat.backbone_module("vgg16"), 16)
    for k, v in again.state_dict().items():
        assert torch.equal(v, ex.net.state_dict()[k]), k
    w = ex.net.state_dict()["block3_conv1.weight"]
    std = (1.0 / w[0].numel()) ** 0.5
    assert float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6
    assert abs(float(w.std()) / std - 1.0) < 0.05
    assert float(ex.net.state_dict()["block3_conv1.bias"].abs().max()) == 0
    inc = tfeat.flax_init_(tfeat.backbone_module("inception"), 299)
    sd = inc.state_dict()
    assert float(sd["stem_0.bn_var"].min()) == 1.0
    assert float(sd["mixed8_1_bp.bn_mean"].abs().max()) == 0.0
    feats = tfeat.extract_features(
        np.random.RandomState(0).rand(2, 28, 28, 1).astype(np.float32), ex)
    assert feats.shape == (2, 512) and np.isfinite(feats).all()


def test_backbone_weights_status_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("NVAE_TPU_WEIGHTS", str(tmp_path / "w"))
    names = ["vgg16", "vgg", "inception", "inception_v3", "iv3",
             "random_conv"]
    for fn in (tfeat.backbone_weights_status, jfeat.backbone_weights_status):
        assert [fn(n) for n in names] == ["random-init"] * 5 + ["fixed-seed"]
        with pytest.raises(ValueError):
            fn("resnet")
    os.makedirs(tmp_path / "w")
    (tmp_path / "w" / "vgg16.npz").write_bytes(b"")
    (tmp_path / "iv3.npz").write_bytes(b"")
    for fn in (tfeat.backbone_weights_status, jfeat.backbone_weights_status):
        assert fn("vgg16") == "imagenet"
        assert fn("inception") == "random-init"
        assert fn("inception", str(tmp_path / "iv3.npz")) == "imagenet"


# ---- the image reader ------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filtered_png(img: np.ndarray, shift: int = 0) -> bytes:
    """An 8-bit PNG of 1-4 channels whose rows cycle through filter types
    0-4 from ``shift`` on (a reference encoder of the filters, straight
    from the PNG specification)."""
    h, w, c = img.shape
    raw, prev = b"", [0] * (w * c)
    for y in range(h):
        line, ftype = [int(v) for v in img[y].reshape(-1)], (y + shift) % 5
        out = []
        for i, x in enumerate(line):
            a = line[i - c] if i >= c else 0
            b = prev[i]
            cc = prev[i - c] if i >= c else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, cc)][ftype]
            out.append((x - pred) & 0xFF)
        raw += bytes([ftype] + out)
        prev = line

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         {1: 0, 2: 4, 3: 2, 4: 6}[c], 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _pil_read(path):
    from PIL import Image

    a = np.asarray(Image.open(path))
    return a[..., None] if a.ndim == 2 else a


def test_png_decoder_matches_pil(tmp_path):
    """The port's decoder against PIL on PNGs both writers produce (grey
    and RGB), grey + alpha and RGBA that PIL writes, and a PNG whose rows
    use every filter type."""
    from PIL import Image

    rng = np.random.RandomState(0)
    files = {}
    for c in (1, 3):
        img = rng.randint(0, 256, (9, 13, c)).astype(np.uint8)
        p = tmp_path / f"port_{c}.png"
        p.write_bytes(timg.encode_png(img))
        files[p] = img
        p = tmp_path / f"pil_{c}.png"
        Image.fromarray(img[..., 0] if c == 1 else img).save(p)
        files[p] = img
    for mode, c in (("LA", 2), ("RGBA", 4)):
        img = rng.randint(0, 256, (7, 11, c)).astype(np.uint8)
        img[:3] = 40  # flat rows, which PIL's adaptive filter predicts
        p = tmp_path / f"pil_{mode}.png"
        Image.fromarray(img, mode).save(p)
        files[p] = img
    img = (np.arange(10 * 12 * 3).reshape(10, 12, 3) * 7 % 256).astype(
        np.uint8)
    img[::3] = rng.randint(0, 256, img[::3].shape)
    p = tmp_path / "filters.png"
    p.write_bytes(_filtered_png(img))
    files[p] = img
    for path, img in files.items():
        got = timg.decode_png(path.read_bytes())
        np.testing.assert_array_equal(got, _pil_read(path))
        np.testing.assert_array_equal(got, img)


def test_png_batch_decoder_matches_each_image(tmp_path):
    """``decode_pngs`` on a batch mixing shapes, channel counts, unfiltered
    rows and rows of every filter type, each starting on another type;
    ``ImageDirectory`` over such files of one shape."""
    rng = np.random.RandomState(5)
    blobs, images = [], []
    for c in (1, 2, 3, 4):
        for shape, shift in (((1, 1), 0), ((6, 9), 1), ((6, 9), 3),
                             ((11, 4), 4)):
            img = rng.randint(0, 256, (*shape, c)).astype(np.uint8)
            blobs.append(_filtered_png(img, shift))
            images.append(img)
        blobs.append(timg.encode_png(images[-2]) if c in (1, 3) else
                     _filtered_png(images[-2], 2))
        images.append(images[-2])
    for got, img in zip(timg.decode_pngs(blobs), images):
        np.testing.assert_array_equal(got, img)
    same = [i for i, img in enumerate(images) if img.shape == (6, 9, 3)]
    for i in same:
        (tmp_path / f"{i:02d}.png").write_bytes(blobs[i])
    np.testing.assert_array_equal(timg.load_images_from_dir(str(tmp_path)),
                                  np.stack([images[i] for i in same]))


@pytest.mark.parametrize("mode,match", [
    ("P", "palette"), ("I;16", "bit depth 16"), ("1", "bit depth 1"),
])
def test_png_decoder_refuses_what_it_does_not_read(tmp_path, mode, match):
    from PIL import Image

    img = Image.fromarray(np.arange(16, dtype=np.uint8).reshape(4, 4))
    buf = io.BytesIO()
    img.convert(mode).save(buf, "PNG")
    with pytest.raises(ValueError, match=match):
        timg.decode_png(buf.getvalue())
    buf = io.BytesIO()
    img.save(buf, "PNG", interlace=1)
    if buf.getvalue()[28]:  # PIL wrote an interlaced file
        with pytest.raises(ValueError, match="interlaced"):
            timg.decode_png(buf.getvalue())


def test_image_directory_matches_jax(tmp_path):
    from nvae_tpu.utils.images import ImageDirectory as JaxImageDirectory
    from nvae_tpu.utils.images import load_images_from_dir as jax_load

    rng = np.random.RandomState(3)
    timg.save_images_to_dir(rng.rand(10, 8, 8, 1).astype(np.float32),
                            str(tmp_path))
    (tmp_path / "notes.txt").write_text("not an image")
    port, ref = timg.ImageDirectory(str(tmp_path)), JaxImageDirectory(
        str(tmp_path))
    assert len(port) == len(ref) == 10 and port.files == ref.files
    np.testing.assert_array_equal(port[2:7], ref[2:7])
    assert port[2:7].dtype == np.float32 and port.max_slice_decoded == 5
    np.testing.assert_array_equal(port[4], ref[4])
    assert port[20:30].shape == ref[20:30].shape == (0, 8, 8, 1)
    fresh = timg.ImageDirectory(str(tmp_path), limit=4)
    assert fresh[5:5].shape == (0, 8, 8, 1) and len(fresh) == 4
    np.testing.assert_array_equal(timg.load_images_from_dir(str(tmp_path)),
                                  jax_load(str(tmp_path)))
    assert timg.load_images_from_dir(str(tmp_path)).dtype == np.uint8


def test_jpeg_needs_pillow(tmp_path, monkeypatch):
    import builtins

    from PIL import Image

    img = np.full((6, 6, 3), 128, np.uint8)
    Image.fromarray(img).save(tmp_path / "a.jpg")
    d = timg.ImageDirectory(str(tmp_path))
    assert d[:].shape == (1, 6, 6, 3)  # Pillow is here: it decodes
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match="needs Pillow"):
        d[:]
