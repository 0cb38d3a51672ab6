"""The port's host-side IO against the JAX package, on the CPU: the MRC
codec (round trips and byte equality with the JAX writer in every mode of
``tests/test_io.py``), the stack loader, the image operations (equal to the
JAX versions exactly) and the dataset on a device."""

import io

import numpy as np
import pytest
import torch

from spatialvae_tpu.io import image as jax_image
from spatialvae_tpu.io import loaders as jax_loaders
from spatialvae_tpu.io import mrc as jax_mrc

from spatialvae_torch.data import ArrayDataset
from spatialvae_torch.io import image, loaders, mrc

MODES = [(np.int8, 0), (np.int16, 1), (np.float32, 2), (np.complex64, 4),
         (np.uint16, 6)]


def _stack(dtype, shape=(3, 5, 7), seed=0):
    rng = np.random.RandomState(seed)
    if np.issubdtype(dtype, np.complexfloating):
        return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(dtype)
    if np.issubdtype(dtype, np.floating):
        return rng.randn(*shape).astype(dtype)
    return rng.randint(0, 100, size=shape).astype(dtype)


@pytest.mark.parametrize("dtype,mode", MODES,
                         ids=[np.dtype(d).name for d, _ in MODES])
def test_mrc_round_trip_and_bytes_match_jax(dtype, mode):
    arr = _stack(dtype)
    got, want = io.BytesIO(), io.BytesIO()
    mrc.write_mrc(got, arr, header=mrc.make_header(arr.shape, dtype=dtype))
    jax_mrc.write_mrc(want, arr,
                      header=jax_mrc.make_header(arr.shape, dtype=dtype))
    assert got.getvalue() == want.getvalue()
    out, hdr, ext = mrc.parse_mrc(got.getvalue())
    assert hdr.mode == mode == mrc.mode_for_dtype(dtype)
    assert (hdr.nx, hdr.ny, hdr.nz) == (7, 5, 3) and ext == b""
    np.testing.assert_array_equal(out, arr)
    assert hdr == mrc.MrcHeader(**vars(jax_mrc.parse_mrc(
        want.getvalue())[1]))


def test_mrc_default_header_extended_header_and_squeeze_match_jax():
    arr = np.random.RandomState(1).randn(1, 6, 6).astype(np.float32)
    ext = b"EXTENDED" * 4
    got, want = io.BytesIO(), io.BytesIO()
    mrc.write_mrc(got, arr, extended_header=ext, ax=2.0, gamma=90.0)
    jax_mrc.write_mrc(want, arr, extended_header=ext, ax=2.0, gamma=90.0)
    assert got.getvalue() == want.getvalue()
    out, hdr, ext2 = mrc.parse_mrc(got.getvalue())
    assert out.shape == (6, 6) and ext2 == ext and hdr.next == len(ext)
    assert len(mrc.MrcHeader().pack()) == 1024
    with pytest.raises(ValueError):
        mrc.mode_for_dtype(np.float64)
    bad = bytearray(got.getvalue())
    bad[12:16] = (5).to_bytes(4, "little")            # mode 5: unknown
    with pytest.raises(ValueError, match="mode 5"):
        mrc.parse_mrc(bytes(bad))


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint16, np.int8,
                                   np.complex64],
                         ids=lambda d: np.dtype(d).name)
def test_load_images_matches_jax(tmp_path, dtype):
    """The JAX loader decodes the real modes to float32 (its C++ helper);
    the port's numpy decode gives the same values and dtype."""
    arr = _stack(dtype, (4, 6, 5), seed=2)
    path = str(tmp_path / "s.mrcs")
    with open(path, "wb") as f:
        mrc.write_mrc(f, arr, header=mrc.make_header(arr.shape, dtype=dtype))
    got, want = loaders.load_images(path), jax_loaders.load_images(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.save(tmp_path / "s.npy", arr)
    np.testing.assert_array_equal(
        loaders.load_images(str(tmp_path / "s.npy")), arr)
    with pytest.raises(ValueError, match="unsupported"):
        loaders.load_images(str(tmp_path / "s.png"))


def test_truncated_mrc_raises(tmp_path):
    arr = np.arange(3 * 5 * 7, dtype=np.float32).reshape(3, 5, 7)
    buf = io.BytesIO()
    mrc.write_mrc(buf, arr, header=mrc.make_header(arr.shape))
    path = tmp_path / "trunc.mrc"
    path.write_bytes(buf.getvalue()[:-40])
    with pytest.raises(ValueError):
        loaders.load_images(str(path))


def test_image_operations_equal_jax_exactly():
    rng = np.random.RandomState(3)
    x = (rng.randn(6, 18, 20) * 4 + 3).astype(np.float32)
    np.testing.assert_array_equal(image.crop(x, 9), jax_image.crop(x, 9))
    np.testing.assert_array_equal(image.normalize(x),
                                  jax_image.normalize(x))
    np.testing.assert_array_equal(image.normalize(x, radius=4),
                                  jax_image.normalize(x, radius=4))
    got = image.normalize_whole(x)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_image.normalize_whole(x))
    np.testing.assert_allclose(got.reshape(6, -1).mean(1), 0.0, atol=1e-5)
    for kw in (dict(factor=2), dict(shape=(8, 10))):
        np.testing.assert_array_equal(image.downsample(x, **kw),
                                      jax_image.downsample(x, **kw))
    # the input is not written
    y = x.copy()
    image.normalize_whole(y)
    np.testing.assert_array_equal(y, x)


def test_array_dataset_on_a_device():
    y = np.random.RandomState(4).randn(5, 36).astype(np.float64)
    ctf = np.ones((5, 3, 3))
    ds = ArrayDataset.from_numpy(y, ctf, device="cpu")
    assert len(ds) == 5
    assert ds.y.dtype == ds.ctf.dtype == torch.float32
    assert ds.y.device == torch.device("cpu")
    np.testing.assert_array_equal(ds.y.numpy(), y.astype(np.float32))
    assert ArrayDataset.from_numpy(y, device="cpu").ctf is None
