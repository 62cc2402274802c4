"""The port's IO against the JAX package's: its native runtime is a
byte-identical copy of ``ofri_io.cpp`` and decodes TIFFs as the JAX runtime
and PIL do; ``save_flow`` writes the same MATLAB schema field for field;
``normalize_16bit_to_8bit`` is the same map."""

import os

import numpy as np
import pytest
import scipy.io
from PIL import Image

from opticalflow_ri_tpu.utils import io as jio
from opticalflow_ri_tpu.utils import native as jnative

from opticalflow_ri_tpu_torch.utils import io as tio
from opticalflow_ri_tpu_torch.utils import native as tnative
from test_torch_cuda_campaign import write_tiff

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_tiff(path, arr):
    Image.fromarray(arr).save(path, compression=None)


def test_native_source_is_the_jax_copy():
    with open(os.path.join(ROOT, "opticalflow_ri_tpu", "utils", "native", "ofri_io.cpp"),
              "rb") as f:
        original = f.read()
    assert tnative.SOURCE.read_bytes() == original


def test_native_builds_into_the_ignored_build_dir():
    assert tnative.available()
    lib = tnative.library_path()
    assert lib.is_file() and lib.parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.relative_to(ROOT).parts[0] == "build"


@pytest.mark.parametrize("dtype,shape", [(np.uint8, (37, 53)), (np.uint16, (24, 31)),
                                         (np.uint8, (1, 7))])
def test_tiff_decode_matches_jax_and_pil(tmp_path, dtype, shape):
    rng = np.random.default_rng(int(np.dtype(dtype).itemsize) * 100 + shape[0])
    arr = rng.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)
    p = str(tmp_path / "a.tif")
    _write_tiff(p, arr)
    got = tnative.tiff_read(p)
    assert got is not None and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(Image.open(p), dtype=np.float32))
    if jnative.available():
        np.testing.assert_array_equal(got, jnative.tiff_read(p))
    np.testing.assert_array_equal(tio.load_image(p), jio.load_image(p))


def test_tiff_read_batch(tmp_path):
    rng = np.random.default_rng(2)
    paths, arrs = [], []
    for i in range(6):
        a = rng.integers(0, 255, (16, 20)).astype(np.uint8)
        p = str(tmp_path / f"{i}.tif")
        _write_tiff(p, a)
        paths.append(p)
        arrs.append(a)
    want = np.stack(arrs).astype(np.float32)
    np.testing.assert_array_equal(tnative.tiff_read_batch(paths), want)
    np.testing.assert_array_equal(tio.load_image_batch(paths), want)
    np.testing.assert_array_equal(tio.load_image_batch(paths), jio.load_image_batch(paths))


def test_campaign_tiff_writer_decodes(tmp_path):
    """The card's campaign test writes its frames with its ``write_tiff``
    (no PIL there): the native decoder and PIL read them back exactly."""
    arr = np.random.default_rng(3).integers(0, 256, (29, 41)).astype(np.uint8)
    p = str(tmp_path / "w.tif")
    write_tiff(p, arr)
    np.testing.assert_array_equal(tnative.tiff_read(p), arr.astype(np.float32))
    np.testing.assert_array_equal(np.asarray(Image.open(p)), arr)


def test_load_image_fallbacks(tmp_path):
    arr = np.random.default_rng(4).integers(0, 255, (12, 9)).astype(np.uint8)
    png = str(tmp_path / "a.png")
    Image.fromarray(arr).save(png)
    np.testing.assert_array_equal(tio.load_image(png), arr.astype(np.float32))  # through PIL
    with pytest.raises(FileNotFoundError):
        tio.load_image(str(tmp_path / "missing.tif"))
    with pytest.raises(FileNotFoundError):
        tio.load_image_batch([png, str(tmp_path / "missing.tif")])


def _mat_fields(path):
    m = scipy.io.loadmat(path)
    vel, par = m["velocities"][0, 0], m["parameters"][0, 0]
    margins = vel["margins"][0, 0]
    return ({k: vel[k] for k in ("u", "v", "iaWidth", "iaHeight")}
            | {f"margins.{k}": margins[k] for k in ("top", "left", "bottom", "right")}
            | {f"parameters.{k}": par[k] for k in ("overlapFactor", "imageHeight", "imageWidth")})


def test_save_flow_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    u = rng.normal(size=(15, 22)).astype(np.float32)
    v = rng.normal(size=(15, 22)).astype(np.float32)
    tio.save_flow(u, v, str(tmp_path / "t.mat"))
    jio.save_flow(u, v, str(tmp_path / "j.mat"))
    got, want = _mat_fields(str(tmp_path / "t.mat")), _mat_fields(str(tmp_path / "j.mat"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["u"], u)


def test_native_save_flow_roundtrip(tmp_path):
    rng = np.random.default_rng(6)
    u = rng.normal(size=(15, 22)).astype(np.float32)
    v = rng.normal(size=(15, 22)).astype(np.float32)
    p = str(tmp_path / "flow.mat")
    assert tnative.save_flow(p, u, v)
    got = _mat_fields(p)
    np.testing.assert_allclose(got["u"], u, rtol=1e-6)
    np.testing.assert_allclose(got["v"], v, rtol=1e-6)
    assert float(np.squeeze(got["parameters.imageHeight"])) == 15
    assert float(np.squeeze(got["margins.top"])) == 0


@pytest.mark.parametrize("peak", [200.0, 4000.0])
def test_normalize_16bit_to_8bit_matches_jax(peak):
    img = np.random.default_rng(7).uniform(0, peak, (9, 13)).astype(np.float32)
    got, want = tio.normalize_16bit_to_8bit(img), jio.normalize_16bit_to_8bit(img)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
