"""The port's evaluation protocol, FID path API and ``--mode test`` against
the JAX package's on the CPU at a tiny size.

The protocol: in each package the five functions the orchestrator calls
(``extract_features``, ``knn_precision_recall_features``,
``fid_from_features``, ``ppl.evaluate``, ``neg_log_likelihood``) and
``get_extractor`` are replaced by recorders that return the same fixed
values, call by call.  The two packages' models sample with their own
noise (the JAX keys cannot be shared with the port); what is compared is
every call they make (backbone and options, input shapes, which feature
sets go to P&R, FID and PPL, in which order, quantized or not) and the
``to_dict()`` they build from the recorded values, which must be equal.

The FID path API: both packages over the same image directories with the
same ``random_conv`` weights (JAX's fixed init carried across): the
statistics at rtol 1e-5 (features agree to ~1e-7 of their norm) and the
FIDs at rtol 1e-4 (an fp64 distance between those statistics, whose trace
terms cancel to a few parts in 1e3 of their size).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvae_torch.eval.evaluate as tev
import nvae_tpu.eval.evaluate as jev
from nvae_torch import cli
from nvae_torch.config import TrainConfig as TorchTrainConfig
from nvae_torch.config import debug_config as torch_debug_config
from nvae_torch.convert import backbone_state_dict_from_flax
from nvae_torch.data import make_iterators as torch_iterators
from nvae_torch.data import synthetic_dataset as torch_synthetic
from nvae_torch.eval import features as tfeat
from nvae_torch.eval import fid as tfid
from nvae_torch.train.trainer import Trainer as TorchTrainer
from nvae_torch.utils.images import save_images_to_dir
from nvae_tpu.config import TrainConfig as JaxTrainConfig
from nvae_tpu.config import debug_config as jax_debug_config
from nvae_tpu.data import make_iterators as jax_iterators
from nvae_tpu.data import synthetic_dataset as jax_synthetic
from nvae_tpu.eval import features as jfeat
from nvae_tpu.eval import fid as jfid
from nvae_tpu.train.trainer import Trainer as JaxTrainer
from tests.test_torch_trainer import TINY_ARCH, single_torch_thread

BATCH = 4
TINY = dict(n_encoder_channels=8, n_decoder_channels=8,
            n_groups_per_scale=(1, 1), n_latent_per_group=2,
            n_preprocess_blocks=1, n_preprocess_cells=2,
            n_postprocess_blocks=1, n_postprocess_cells=2,
            use_pallas_kernels=True)


@pytest.fixture(autouse=True)
def one_torch_thread():
    with single_torch_thread():
        yield


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """Each package's trainer and test iterator: 8 test images, batches of
    4 (so 4 P&R halves of 2)."""
    tmp = tmp_path_factory.mktemp("evaluate")
    jb = jax_synthetic(n_train=8, n_test=8, seed=0)
    _, jit_ = jax_iterators(jb, BATCH, seed=0)
    jt = JaxTrainer(jax_debug_config(**TINY), JaxTrainConfig(
        epochs=1, batch_size=BATCH, model_save_dir=str(tmp / "j")), 2)
    tb = torch_synthetic(n_train=8, n_test=8, seed=0)
    _, tit = torch_iterators(tb, BATCH, seed=0, device="cpu")
    tt = TorchTrainer(torch_debug_config(**TINY), TorchTrainConfig(
        epochs=1, batch_size=BATCH, model_save_dir=str(tmp / "t")), 2,
        device="cpu")
    return (jt, jit_), (tt, tit)


class Recorder:
    """The orchestrator's six collaborators, recording each call and
    returning values that depend only on the call's position."""

    def __init__(self, torch_side: bool):
        self.torch_side = torch_side
        self.calls = []
        self.counts = {}

    def _next(self, kind):
        self.counts[kind] = self.counts.get(kind, 0) + 1
        return self.counts[kind]

    @staticmethod
    def _print(x):
        """Fingerprint of a feature array the recorder handed out."""
        return round(float(np.asarray(x, np.float64).sum()), 6)

    def get_extractor(self, name, input_size=0, weights_path=None,
                      resize_method="bilinear", input_scaling="pm1",
                      device=None):
        if self.torch_side:
            assert device is not None and torch.device(device).type == "cpu"
        return (name, input_size, resize_method, input_scaling)

    def extract_features(self, images, extractor, *args, **kwargs):
        i = self._next("features")
        x = np.asarray(images.cpu() if isinstance(images, torch.Tensor)
                       else images, np.float32)
        quantized = bool(np.all(np.abs(x * 255 - np.round(x * 255)) < 1e-3))
        feats = np.random.RandomState(i).randn(len(x), 4).astype(np.float32)
        self.calls.append(("features", extractor, x.shape, quantized,
                           self._print(feats)))
        return feats

    def knn_precision_recall_features(self, ref, ev, *args, **kwargs):
        i = self._next("pr")
        self.calls.append(("pr", self._print(ref), self._print(ev)))
        return {"precision": (i % 7) / 7.0, "recall": (i % 5) / 5.0}

    def fid_from_features(self, a, b, *args, **kwargs):
        i = self._next("fid")
        self.calls.append(("fid", np.shape(a), np.shape(b), self._print(a),
                           self._print(b)))
        return 10.0 + i

    def ppl_evaluate(self, a, b, *args, **kwargs):
        i = self._next("ppl")
        self.calls.append(("ppl", np.shape(a), self._print(a),
                           self._print(b)))
        return 100.0 * i

    def nll(self, model, *args, **kwargs):
        batches = args[1] if not self.torch_side else args[0]
        self.calls.append(("nll", [tuple(np.shape(b)) for b in batches],
                           kwargs["n_attempts"]))
        return 800.5, 3.25

    def install(self, monkeypatch, mod, ppl_mod):
        for name in ("get_extractor", "extract_features",
                     "knn_precision_recall_features", "fid_from_features"):
            monkeypatch.setattr(mod, name, getattr(self, name))
        monkeypatch.setattr(mod, "neg_log_likelihood", self.nll)
        monkeypatch.setattr(ppl_mod, "evaluate", self.ppl_evaluate)


SWITCHES = ("pr_parity_accounting", "pr_parity_orientation",
            "parity_resize_299", "parity_fid_uint8", "parity_unit_input")


@pytest.mark.parametrize("switches", [(), *[(s,) for s in SWITCHES],
                                      SWITCHES],
                         ids=["default", *SWITCHES, "eval_parity"])
def test_protocol_matches_jax(trainers, monkeypatch, switches):
    (jt, jit_), (tt, tit) = trainers
    kw = dict(batch_size=BATCH, n_attempts=2, temperatures=(0.8, 1.0),
              fid_sample_size=2 * BATCH, feature_backbone="random_conv",
              fid_backbone="vgg16", **{s: True for s in switches})
    results = {}
    for side, mod, trainer, test_iter in (("jax", jev, jt, jit_),
                                          ("torch", tev, tt, tit)):
        rec = Recorder(side == "torch")
        rec.install(monkeypatch, mod, mod.ppl_mod)
        evaluation = mod.evaluate_model(trainer, test_iter, **kw)
        results[side] = (rec.calls, evaluation)
    (jcalls, jeval), (tcalls, teval) = results["jax"], results["torch"]
    assert tcalls == jcalls
    assert teval.to_dict() == jeval.to_dict()
    assert teval.comparable() is jeval.comparable() is False
    # What the protocol is: 2 temperatures x 2 attempts x (4 halves + 2
    # PPL) feature calls, 4 real halves and the real FID set once, 2 FID
    # batches per temperature.
    kinds = [c[0] for c in tcalls]
    assert kinds.count("pr") == 2 * 2 * 4 and kinds.count("ppl") == 4
    assert kinds.count("features") == 1 + 4 + 2 * 2 * (4 + 2) + 2 * 2
    fid_inputs = [c for c in tcalls if c[0] == "features"
                  and c[1][0] == "vgg16"]
    assert all(c[3] for c in fid_inputs) == ("parity_fid_uint8" in switches)


def test_quantize_uint8_matches_jax():
    x = np.random.RandomState(0).rand(3, 5, 5, 1).astype(np.float32)
    x[0, 0, 0, 0], x[0, 0, 1, 0] = 1.2, -0.1
    want = jev.quantize_uint8(x)
    np.testing.assert_array_equal(tev.quantize_uint8(x), want)
    np.testing.assert_array_equal(
        tev.quantize_uint8(torch.from_numpy(x)).numpy(), want)


def test_model_evaluation_keys_match_jax():
    def build(mod):
        m = mod.Metric(1.0, 0.5)
        return mod.ModelEvaluation(
            nll=m, sample_metrics=[mod.Metrics(0.6, 3.0, m, m, m)],
            feature_backbone="vgg16", feature_backbone_weights="imagenet",
            fid_backbone_weights="imagenet")

    assert build(tev).to_dict() == build(jev).to_dict()
    assert build(tev).comparable() and build(jev).comparable()
    assert str(tev.Metric(1.0, 0.5)) == str(jev.Metric(1.0, 0.5))
    assert tev.EVAL_TEMPERATURES == jev.EVAL_TEMPERATURES
    assert tev.FID_SAMPLE_SIZE == jev.FID_SAMPLE_SIZE


def test_evaluate_model_runs_the_real_functions(trainers, capsys):
    """The unpatched protocol at a tiny size (halves of 4, the fewest
    that k=3 takes): finite metrics in range, the provenance tags, the
    warning, and the model's mode kept."""
    _, (tt, _) = trainers
    _, tit = torch_iterators(torch_synthetic(n_train=8, n_test=16, seed=0),
                             2 * BATCH, seed=0, device="cpu")
    tt.model.train()
    ev = tev.evaluate_model(tt, tit, batch_size=2 * BATCH, n_attempts=1,
                            temperatures=(1.0,), fid_sample_size=2 * BATCH,
                            feature_backbone="random_conv",
                            fid_backbone="random_conv",
                            pr_parity_accounting=True)
    assert tt.model.training
    assert "framework-internal only" in capsys.readouterr().out
    m = ev.sample_metrics[0]
    assert np.isfinite(m.fid) and m.fid >= 0 and np.isfinite(m.ppl.mean)
    assert 0.0 <= m.precision.mean <= 2.0 and 0.0 <= m.recall.mean <= 2.0
    assert np.isfinite(ev.nll.mean) and ev.nll.mean > 0
    assert ev.feature_backbone_weights == ev.fid_backbone_weights == \
        "fixed-seed"


def test_evaluate_fid_against_dir(trainers, tmp_path):
    _, (tt, _) = trainers
    real = tmp_path / "real"
    save_images_to_dir(np.random.RandomState(0).rand(8, 32, 32, 1), str(real))
    out = tmp_path / "gen"
    out.mkdir()
    (out / "old.png").write_bytes(b"stale")
    (out / "keep.txt").write_text("not an image")
    fid = tev.evaluate_fid_against_dir(tt, str(real), str(out), BATCH, 1.0,
                                       sample_size=2 * BATCH,
                                       feature_backbone="random_conv")
    assert np.isfinite(fid) and fid >= 0
    names = os.listdir(out)
    assert "keep.txt" in names and "old.png" not in names
    assert len([n for n in names if n.endswith(".png")]) == 2 * BATCH


# ---- the FID path API ------------------------------------------------------


@pytest.fixture(scope="module")
def shared_random_conv():
    """A port extractor holding the JAX package's random_conv weights."""
    v = jfeat._RandomConvNet().init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 64, 3)))
    net = tfeat.backbone_module("random_conv")
    net.load_state_dict(backbone_state_dict_from_flax(
        "random_conv", jax.tree_util.tree_map(np.asarray, v)))
    return tfeat.Extractor("random_conv", net.eval(), 64, "bilinear", "pm1",
                           torch.device("cpu"), "fixed-seed")


@pytest.fixture
def image_dirs(tmp_path, monkeypatch, shared_random_conv):
    seen = []

    def get_extractor(name, input_size=0, device="cuda", **kw):
        seen.append((name, input_size, str(device)))
        return shared_random_conv

    monkeypatch.setattr(tfid, "get_extractor", get_extractor)
    rng = np.random.RandomState(5)
    a, b = tmp_path / "a", tmp_path / "b"
    save_images_to_dir(rng.rand(12, 16, 16, 1), str(a))
    save_images_to_dir(rng.rand(12, 16, 16, 1) ** 2, str(b))
    return a, b, seen


def test_fid_path_api_matches_jax(image_dirs, tmp_path):
    a, b, seen = image_dirs
    mu, sigma = tfid.compute_statistics_of_path(str(a), "random_conv",
                                                batch_size=5, device="cpu")
    jmu, jsigma = jfid.compute_statistics_of_path(str(a), "random_conv",
                                                  batch_size=5)
    np.testing.assert_allclose(mu, jmu, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(sigma, jsigma, rtol=1e-5, atol=1e-9)
    got = tfid.calculate_fid_given_paths([str(a), str(b)], "random_conv",
                                         device="cpu")
    want = jfid.calculate_fid_given_paths([str(a), str(b)], "random_conv")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert seen and all(s == ("random_conv", 0, "cpu") for s in seen)
    # Statistics saved by one package score in the other.
    tfid.save_statistics(str(tmp_path / "s" / "a.npz"), mu, sigma)
    np.testing.assert_allclose(
        jfid.calculate_fid_given_paths([str(tmp_path / "s" / "a.npz"),
                                        str(b)], "random_conv"), want,
        rtol=1e-4)
    with pytest.raises(FileNotFoundError):
        tfid.compute_statistics_of_path(str(tmp_path / "missing"),
                                        device="cpu")


def test_fid_command_line_matches_jax(image_dirs, tmp_path, capsys):
    a, b, seen = image_dirs
    for name, main, extra in (("t", tfid.main, ["--cpu"]),
                              ("j", jfid.main, [])):
        npz = str(tmp_path / f"{name}.npz")
        assert main([str(a), npz, "--save_stats", "--backbone",
                     "random_conv", *extra]) == 0
        assert main([npz, str(b), "--backbone", "random_conv",
                     *extra]) == 0
    out = capsys.readouterr().out.splitlines()
    fids = [float(line.split()[1]) for line in out if line.startswith("FID:")]
    assert len(fids) == 2 and "(D=512)" in out[0]
    np.testing.assert_allclose(fids[0], fids[1], rtol=1e-4)
    t, j = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    np.testing.assert_allclose(t["mu"], j["mu"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t["sigma"], j["sigma"], rtol=1e-5, atol=1e-9)
    assert seen[-1] == ("random_conv", 0, "cpu")


# ---- --mode test -----------------------------------------------------------


def _test_argv(tmp_path, *extra):
    return ["--mode", "test", "--dataset", "synthetic", "--debug", "--cpu",
            "--batch_size", "8", "--seed", "0", *TINY_ARCH, "--use_pallas",
            "--model_save_dir", str(tmp_path / "models"),
            "--tensorboard_log_dir", str(tmp_path / "logs"),
            "--eval_attempts", "1", "--eval_temperatures", "0.8", "1.0",
            "--fid_sample_size", "16", "--feature_backbone", "random_conv",
            "--fid_backbone", "random_conv", *extra]


def test_cli_mode_test_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``--mode test --cpu`` at debug size on a trained checkpoint exits 0
    and writes an evaluation.json with the JAX package's keys; with
    ``--eval_parity`` the P&R accounting is the reference's."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cli.main(["--mode", "train", "--epochs", "1",
              "--model_save_frequency", "1", "--evaluate_frequency", "0",
              "--sample_frequency", "0",
              *_test_argv(tmp_path)[2:]])
    cli.main(_test_argv(tmp_path))
    out = capsys.readouterr().out
    assert "Evaluating checkpoint at epoch 1" in out
    assert "Negative log likelihood:" in out
    stages = json.loads(out.split("Stage seconds: ")[1].splitlines()[0])
    assert set(stages) == {"sampling", "random_conv features",
                           "precision/recall", "ppl", "fid", "nll"}
    assert all(v > 0 for v in stages.values())
    with open(tmp_path / "logs" / "evaluation.json") as f:
        d = json.load(f)
    ref = jev.ModelEvaluation(
        nll=jev.Metric(0.0, 0.0),
        sample_metrics=[jev.Metrics(0.8, 0.0, *[jev.Metric(0.0, 0.0)] * 3)],
    ).to_dict()

    def keys(x):
        if isinstance(x, dict):
            return {k: keys(v) for k, v in x.items()}
        if isinstance(x, list):
            return [keys(v) for v in x[:1]]
        return None

    assert keys(d) == keys(ref)
    assert [m["temperature"] for m in d["sample_metrics"]] == [0.8, 1.0]
    assert d["feature_backbone_weights"] == "fixed-seed"
    flat = [d["nll"]["mean"]] + [m["fid"] for m in d["sample_metrics"]]
    assert all(np.isfinite(flat))
    cli.main(_test_argv(tmp_path, "--eval_parity",
                        "--eval_temperatures", "1.0"))
    with open(tmp_path / "logs" / "evaluation.json") as f:
        d = json.load(f)
    assert len(d["sample_metrics"]) == 1
    assert 0.0 <= d["sample_metrics"][0]["precision"]["mean"] <= 2.0


def test_cli_mode_test_needs_the_card_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _test_argv(tmp_path) if a != "--cpu"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_cli_declares_the_jax_eval_flags():
    import nvae_tpu.cli as jcli

    argv = ["--eval_attempts", "3", "--eval_temperatures", "0.7",
            "--fid_sample_size", "100", "--feature_backbone", "inception",
            "--fid_backbone", "vgg16", "--pr_parity_accounting",
            "--pr_parity_orientation", "--parity_resize_299",
            "--parity_fid_uint8", "--parity_unit_input", "--eval_parity"]
    keys = [a[2:] for a in argv if a.startswith("--")]
    for args in ([], argv):
        port, ref = vars(cli.parse_args(args)), vars(jcli.parse_args(args))
        assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
