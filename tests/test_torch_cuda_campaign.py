"""The campaign runner on the card: TIFF pairs in, ``.mat`` flows out.

Marked ``cuda``; the test skips without a CUDA device (decided in the test,
never at import).  Run on the machine with the card, which has no JAX and no
PIL, with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_campaign.py -q

Thirty 512^2 pairs written as uncompressed 8-bit TIFFs (``write_tiff``, the
camera's format, which the native decoder reads) and one missing pair go
through ``harness.batch_runner.FlowBatchRunner`` at batch 8: a first run of
16 pairs, then a resume over all 31; the batch with the missing pair lands
in ``failed`` and the rest in ``done``, and every ``.mat`` equals eager
``run_config`` on the decoded frames bit for bit.
"""

import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

CONFIG = "HS_Fs3_4"


def write_tiff(path: str, im: np.ndarray) -> None:
    """An (H, W) uint8 image as an uncompressed little-endian grayscale TIFF,
    one strip: what PIV cameras write and the native decoder reads."""
    h, w = im.shape
    tags = [(256, 4, w), (257, 4, h), (258, 3, 8), (259, 3, 1), (262, 3, 1),
            (273, 4, 8 + 2 + 12 * 9 + 4), (277, 3, 1), (278, 4, h), (279, 4, h * w)]
    ifd = np.zeros(len(tags), dtype=[("tag", "<u2"), ("type", "<u2"), ("count", "<u4"),
                                     ("value", "<u4")])
    for i, (tag, typ, value) in enumerate(tags):
        ifd[i] = (tag, typ, 1, value)
    with open(path, "wb") as f:
        f.write(b"II" + np.array([42], "<u2").tobytes() + np.array([8], "<u4").tobytes())
        f.write(np.array([len(tags)], "<u2").tobytes() + ifd.tobytes())
        f.write(np.array([0], "<u4").tobytes())  # no next IFD
        f.write(np.ascontiguousarray(im, np.uint8).tobytes())


def write_campaign(work: str) -> list:
    """30 pairs of 512^2 particle frames as TIFFs in ``work`` and a missing
    pair at position 20: the runner's ``(name, frame 0, frame 1)`` list."""
    from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

    pairs = []
    for i in range(30):
        a, b, _, _ = particle_image_pair(shape=(512, 512), seed=100 + i)
        paths = [os.path.join(work, f"p{i:02d}_{j}.tif") for j in (0, 1)]
        for p, im in zip(paths, (a, b)):
            write_tiff(p, np.clip(np.rint(im), 0, 255).astype(np.uint8))
        pairs.append((f"p{i:02d}", *paths))
    pairs.insert(20, ("missing", os.path.join(work, "nope_0.tif"),
                      os.path.join(work, "nope_1.tif")))
    return pairs


def read_flow(path: str) -> tuple:
    import scipy.io

    vel = scipy.io.loadmat(path)["velocities"]
    return vel["u"][0, 0], vel["v"][0, 0]


def test_campaign_runs_resumes_and_matches_eager(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels are built with nvcc for sm_90a)")
    from opticalflow_ri_tpu_torch.configs import run_config
    from opticalflow_ri_tpu_torch.harness.batch_runner import FlowBatchRunner
    from opticalflow_ri_tpu_torch.utils.io import load_image

    pairs = write_campaign(str(tmp_path))
    out = str(tmp_path / "out")
    first = FlowBatchRunner(CONFIG, batch_size=8, output_dir=out).run(pairs[:16])
    state = FlowBatchRunner(CONFIG, batch_size=8, output_dir=out).run(pairs)  # the resume
    lost = sorted(p[0] for p in pairs[16:24])  # the batch that holds the missing pair
    assert sorted(first["done"]) == sorted(p[0] for p in pairs[:16])
    assert sorted(state["done"]) == sorted(p[0] for p in pairs if p[0] not in lost)
    assert sorted(state["failed"]) == lost
    for name, p0, p1 in pairs:
        if name in lost:
            continue
        want = run_config(CONFIG, load_image(p0), load_image(p1))
        for got, w in zip(read_flow(os.path.join(out, f"{name}.mat")), want):
            np.testing.assert_array_equal(got, w.cpu().numpy())
