"""The port's campaign runner with a mesh (``FlowBatchRunner(mesh=...)``) on
four gloo ranks on the CPU, against its single-device runs and the JAX
package's runner.

One group of four ranks per module (``subprocess`` children that never
import jax, rendezvous by ``file://`` in ``tmp_path``), every rank on the
same pair list: each decodes, computes and writes only its slice of each
batch; rank 0 alone writes ``progress.json``.  The parent compares the
``.mat`` files and the ``done``/``failed`` sets.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.io

from test_torch_parallel import spawn_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import json, os, sys
rank, world, init, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
import torch
torch.set_num_threads(1)
from opticalflow_ri_tpu_torch.harness.batch_runner import FlowBatchRunner
from opticalflow_ri_tpu_torch.parallel import distributed, make_mesh

distributed.initialize(init, world, rank, device="cpu")
mesh = make_mesh(batch=world, device_type="cpu")
with open(os.path.join(work, "cases.json")) as f:
    cases = json.load(f)
facts = {}
for case, pairs in cases.items():
    pairs = [tuple(p) for p in pairs]
    out = os.path.join(work, case, "mesh")
    run = lambda ps: FlowBatchRunner("HS_Fs0_0", batch_size=4, output_dir=out, device="cpu",
                                     mesh=mesh).run(ps)
    first = run(pairs[:5])
    state = run(pairs)
    again = run(pairs)  # every pair done: nothing to do
    facts[case] = {"first": first, "state": state, "again": again}
    with open(os.path.join(out, "progress.json")) as f:
        facts[case]["file"] = json.load(f)

for label, kw, m in (("batch_size", {"batch_size": 3}, mesh),
                     ("pipeline", {"batch_size": 4, "pipeline": "batched"}, mesh),
                     ("spatial", {"batch_size": 4}, make_mesh(shape=(1, 2, 2), device_type="cpu"))):
    try:
        FlowBatchRunner("HS_Fs0_0", output_dir=os.path.join(work, "nope"), device="cpu",
                        mesh=m, **kw)
        facts[f"raises_{label}"] = False
    except ValueError:
        facts[f"raises_{label}"] = True
with open(os.path.join(work, f"facts{rank}.json"), "w") as f:
    json.dump(facts, f)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print("RANK_OK", rank)
"""


def _write_pairs(work, n, missing_at=None):
    from PIL import Image

    from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

    pairs = []
    for i in range(n):
        a, b, _, _ = particle_image_pair(shape=(48, 48), seed=i)
        paths = [str(work / f"f{i}_{j}.tif") for j in (0, 1)]
        for p, im in zip(paths, (a, b)):
            Image.fromarray(im.astype(np.uint8)).save(p)
        pairs.append((f"pair{i}", *paths))
    if missing_at is not None:
        pairs.insert(missing_at, ("missing", str(work / "nope_0.tif"), str(work / "nope_1.tif")))
    return pairs


def _single(pairs, out):
    """The single-device runner on the same schedule: the first 5, a resume."""
    from opticalflow_ri_tpu_torch.harness.batch_runner import FlowBatchRunner

    run = lambda ps: FlowBatchRunner("HS_Fs0_0", batch_size=4, output_dir=str(out),  # noqa: E731
                                     device="cpu").run(ps)
    return run(pairs[:5]), run(pairs)


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    work = tmp_path_factory.mktemp("runner")
    cases = {"clean": _write_pairs(work, 6),
             # a missing pair in the second batch of the resume, a ragged
             # tail whose last slices are empty on some ranks
             "missing": _write_pairs(work, 9, missing_at=6)}
    single = {}
    for case, pairs in cases.items():
        (work / case).mkdir()
        single[case] = _single(pairs, work / case / "single")
    with open(work / "cases.json", "w") as f:
        json.dump(cases, f)
    spawn_ranks(_CHILD, work, work)
    facts = []
    for r in range(4):
        with open(work / f"facts{r}.json") as f:
            facts.append(json.load(f))
    return work, cases, single, facts


CASES = ["clean", "missing"]


@pytest.mark.parametrize("case", CASES)
def test_mesh_runner_done_failed_equal_single_device(campaign, case):
    _, _, single, facts = campaign
    first, state = single[case]
    for r in range(4):
        got = facts[r][case]
        assert sorted(got["first"]["done"]) == sorted(first["done"])
        assert sorted(got["state"]["done"]) == sorted(state["done"])
        assert sorted(got["state"]["failed"]) == sorted(state["failed"])


@pytest.mark.parametrize("case", CASES)
def test_mesh_runner_mat_files_equal_single_device(campaign, case):
    work, cases, single, _ = campaign
    mesh_dir, single_dir = work / case / "mesh", work / case / "single"
    written = sorted(f for f in os.listdir(mesh_dir) if f.endswith(".mat"))
    assert written == sorted(f for f in os.listdir(single_dir) if f.endswith(".mat"))
    assert written == sorted(f"{n}.mat" for n in single[case][1]["done"])
    for name in written:
        got = scipy.io.loadmat(mesh_dir / name)["velocities"]
        want = scipy.io.loadmat(single_dir / name)["velocities"]
        for k in ("u", "v"):
            np.testing.assert_array_equal(got[k][0, 0], want[k][0, 0])


def test_mesh_runner_failure_is_batch_granular(campaign):
    """The missing pair fails its whole batch on every rank, as one
    single-device batch fails."""
    _, cases, single, facts = campaign
    failed = sorted(facts[0]["missing"]["state"]["failed"])
    assert "missing" in failed and len(failed) == 4
    assert failed == sorted(single["missing"][1]["failed"])


@pytest.mark.parametrize("case", CASES)
def test_mesh_runner_progress_file_and_resume(campaign, case):
    """Rank 0's progress.json holds every rank's names; a run with every pair
    done returns it unchanged on every rank."""
    _, _, single, facts = campaign
    for r in range(4):
        f = facts[r][case]
        assert sorted(f["file"]["done"]) == sorted(single[case][1]["done"])
        assert sorted(f["again"]["done"]) == sorted(f["file"]["done"])
        assert f["file"]["config"] == "HS_Fs0_0"


def test_mesh_runner_flows_match_jax_runner(campaign, tmp_path):
    """The JAX package's single-device runner on the clean campaign, at the
    pipeline bar of tests/test_torch_compile.py (AEE <= 5e-6)."""
    from opticalflow_ri_tpu.harness.batch_runner import FlowBatchRunner

    work, cases, _, _ = campaign
    FlowBatchRunner("HS_Fs0_0", batch_size=4, output_dir=str(tmp_path)).run(
        [tuple(p) for p in cases["clean"]])
    for name, _, _ in cases["clean"]:
        got = scipy.io.loadmat(work / "clean" / "mesh" / f"{name}.mat")["velocities"]
        want = scipy.io.loadmat(tmp_path / f"{name}.mat")["velocities"]
        e = float(np.mean(np.hypot(got["u"][0, 0] - want["u"][0, 0],
                                   got["v"][0, 0] - want["v"][0, 0])))
        assert e <= 5e-6, (name, e)


@pytest.mark.parametrize("label", ["batch_size", "pipeline", "spatial"])
def test_mesh_runner_validation(campaign, label):
    """tests/test_batch_stream.py:103-112: a batch size that is no multiple
    of the mesh batch axis and a pipeline other than the scan raise; so does
    a mesh with spatial axes."""
    assert all(campaign[3][r][f"raises_{label}"] for r in range(4))


def test_runner_cli_takes_mesh_batch():
    out = subprocess.run(
        [sys.executable, "-m", "opticalflow_ri_tpu_torch.harness.batch_runner", "--help"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0 and "--mesh-batch" in out.stdout
