"""The port's data layer against the JAX package's on the CPU: the synthetic
dataset byte for byte, ``prepare_batch`` exactly (the same float32 ops; the
Bernoulli draw given the same uniforms), and the iterators' batch order and
truncation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvae_torch.data import (
    DatasetUnavailable,
    load_dataset,
    make_iterators,
    prepare_batch,
    synthetic_dataset,
)
from nvae_torch.data.pipeline import batch_seed
from nvae_tpu import data as jdata


@pytest.mark.parametrize("kwargs", [
    dict(n_train=48, n_test=16, seed=3),
    dict(n_train=8, n_test=4, image_size=32, channels=3, seed=1),
])
def test_synthetic_dataset_is_byte_equal_to_jax(kwargs):
    got, want = synthetic_dataset(**kwargs), jdata.synthetic_dataset(**kwargs)
    for a, b in ((got.train_x, want.train_x), (got.test_x, want.test_x)):
        assert a.dtype == np.uint8 and a.tobytes() == b.tobytes()
    assert (got.name, got.image_size, got.channels) == (
        want.name, want.image_size, want.channels)
    rgb = load_dataset("synthetic_rgb64", n_train=2, n_test=1)
    assert rgb.train_x.shape == (2, 64, 64, 3)


def test_missing_dataset_raises_helpful_error(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("NVAE_TPU_DATA", raising=False)
    with pytest.raises(DatasetUnavailable, match="never downloads"):
        load_dataset("mnist", str(tmp_path))
    with pytest.raises(ValueError, match="unknown dataset"):
        load_dataset("imagenet")


@pytest.mark.parametrize("size,binarize,parity", [
    (28, False, False),  # pad 2 + 2, scale
    (29, False, False),  # pad 1 + 2
    (36, False, False),  # centre crop
    (28, True, True),  # the reference's > 0 threshold
    (32, True, True),
])
def test_prepare_batch_matches_jax_exactly(size, binarize, parity):
    rng = np.random.RandomState(size)
    x = rng.randint(0, 256, size=(3, size, size, 1)).astype(np.uint8)
    x[0, 5, 5, 0] = 1  # the faintest pixel is 1 under the threshold
    got = prepare_batch(torch.from_numpy(x), None, target_size=32,
                        binarize=binarize, parity_binarize_255=parity)
    want = jdata.prepare_batch(jnp.asarray(x), jax.random.PRNGKey(0),
                               target_size=32, binarize=binarize,
                               parity_binarize_255=parity)
    assert got.dtype == torch.float32 and got.shape == (3, 32, 32, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bernoulli_draw_matches_jax_given_its_uniforms():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, size=(4, 28, 28, 1)).astype(np.uint8)
    key = jax.random.PRNGKey(5)
    want = jdata.prepare_batch(jnp.asarray(x), key, target_size=32)
    u = np.array(jax.random.uniform(key, (4, 32, 32, 1)))
    got = prepare_batch(torch.from_numpy(x), target_size=32,
                        uniform=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The padding ring stays 0; a generator gives a fresh draw.
    drawn = prepare_batch(torch.from_numpy(x), torch.Generator().manual_seed(1))
    assert float(drawn[:, :2].sum()) == 0.0
    assert set(np.unique(drawn.numpy())) <= {0.0, 1.0}
    with pytest.raises(ValueError, match="uniform"):
        prepare_batch(torch.from_numpy(x), uniform=torch.zeros(1, 2, 2, 1))


def test_batch_order_matches_jax_over_two_epochs():
    bundle = synthetic_dataset(n_train=40, n_test=16, seed=2)
    kw = dict(batch_size=8, binarize=False, seed=4)
    train, test = make_iterators(bundle, device="cpu", **kw)
    jtrain, jtest = jdata.make_iterators(bundle, **kw)
    assert len(train) == len(jtrain) == 5 and len(test) == len(jtest) == 2
    for e in (0, 1):
        got = [b.numpy() for b in train.epoch(e)]
        want = [np.asarray(b) for b in jtrain.epoch(e)]
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    # The test set is not shuffled.
    for a, b in zip(test.epoch(0), jtest.epoch(0)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # Epochs differ; the same epoch repeats, binarization noise included.
    btrain, _ = make_iterators(bundle, 8, seed=4, device="cpu")
    e0, e1 = list(btrain.epoch(0)), list(btrain.epoch(1))
    assert not torch.equal(e0[0], e1[0])
    assert all(torch.equal(a, b) for a, b in zip(e0, btrain.epoch(0)))
    assert batch_seed(4, 0, 1) != batch_seed(4, 1, 0)


def test_debug_truncates_to_four_batches_and_drops_the_remainder():
    bundle = synthetic_dataset(n_train=100, n_test=70, seed=0)
    train, test = make_iterators(bundle, 8, debug=True, device="cpu")
    assert len(train) == 4 and len(test) == 4
    assert len(list(train.epoch(0))) == 4
    full, _ = make_iterators(bundle, 8, device="cpu")
    assert len(full) == 12 and len(list(full.epoch(0))) == 12
