"""The port's batch PNG writer (``nvae_torch/utils/native_png.py`` over
``nvae_torch/utils/csrc/pngio.cpp``) against the JAX package's
(``nvae_tpu/utils/native_png.py`` over ``native/pngio.cpp``): the same
bytes for the same uint8 images, greyscale and RGB, which the port's PNG
decoder reads back to the input pixels; ``save_images_to_dir`` writes
through it, and through its stdlib encoder where the library is missing."""

import os
import shutil

import numpy as np
import pytest

from nvae_torch.utils import images as timages
from nvae_torch.utils import native_png
from nvae_tpu.utils import native_png as jnative_png


@pytest.fixture(scope="module")
def built():
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler: the native writer cannot be built")
    assert native_png.available()
    if not jnative_png.available():
        pytest.skip("the JAX package's writer did not build (make, g++)")


def _images(n, h, w, c, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, c),
                                               dtype=np.uint8)


@pytest.mark.parametrize("shape", [(3, 32, 32, 1), (2, 17, 23, 3),
                                   (1, 200, 120, 3), (2, 1, 1, 1)])
def test_same_bytes_as_the_jax_writer_and_decodes_back(built, tmp_path,
                                                       shape):
    # (1, 200, 120, 3): a scanline stream past one 65,535-byte stored block.
    imgs = _images(*shape)
    ours = [str(tmp_path / f"ours{i}.png") for i in range(len(imgs))]
    theirs = [str(tmp_path / f"jax{i}.png") for i in range(len(imgs))]
    assert native_png.write_batch(ours, imgs) == len(imgs)
    assert jnative_png.write_batch(theirs, imgs) == len(imgs)
    for a, b, img in zip(ours, theirs, imgs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            data = fa.read()
            assert data == fb.read()
        np.testing.assert_array_equal(timages.decode_png(data), img)


def test_save_images_to_dir_takes_the_native_writer(built, tmp_path):
    imgs = _images(4, 32, 32, 1, seed=1)
    timages.save_images_to_dir(imgs, str(tmp_path / "out"))
    files = sorted(os.listdir(tmp_path / "out"))
    assert len(files) == 4
    ref = [str(tmp_path / f"ref{i}.png") for i in range(4)]
    native_png.write_batch(ref, imgs)
    written = {open(tmp_path / "out" / f, "rb").read() for f in files}
    assert written == {open(p, "rb").read() for p in ref}
    back = timages.load_images_from_dir(str(tmp_path / "out"))
    assert sorted(map(bytes, back)) == sorted(map(bytes, imgs))


def test_save_images_to_dir_without_the_library(built, tmp_path,
                                                monkeypatch):
    """No library: the stdlib encoder writes every file (zlib-compressed,
    so other bytes), and they decode to the same pixels."""
    monkeypatch.setattr(native_png, "available", lambda: False)
    imgs = (np.random.RandomState(2).rand(3, 8, 9, 3)).astype(np.float32)
    timages.save_images_to_dir(imgs, str(tmp_path / "out"))
    files = sorted(os.listdir(tmp_path / "out"))
    assert len(files) == 3
    back = timages.load_images_from_dir(str(tmp_path / "out"))
    assert sorted(map(bytes, back)) == sorted(
        map(bytes, timages.to_uint8(imgs)))


def test_writer_refuses_what_it_cannot_write(built, tmp_path):
    with pytest.raises(ValueError, match="1 or 3 channels"):
        native_png.write_batch([str(tmp_path / "a.png")],
                               _images(1, 4, 4, 4))
    with pytest.raises(ValueError, match="paths for"):
        native_png.write_batch([str(tmp_path / "a.png")],
                               _images(2, 4, 4, 1))
    # A file that cannot be opened is not counted.
    assert native_png.write_batch([str(tmp_path / "no" / "a.png")],
                                  _images(1, 4, 4, 1)) == 0
