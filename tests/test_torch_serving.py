"""The port's serving export (``dispu_tpu_torch/serving.py``) against its
live pipeline and against the JAX package's ``ServedUpsampler``, on the CPU.

At ``tests/test_serving.py``'s configuration, from the same flax init: an
exported entry, saved, loaded and called, returns the bits of the live
``PatchUpsampler.upsample`` and agrees with JAX's served artifact within
``test_torch_inference.py::test_upsample_matches_jax``'s bounds.  The
manifest and the loader's refusals.  The other settings, the CLI's export
phase and a loader process without the model code are
``tests/test_torch_export.py``'s.
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from dispu_tpu.config import GeneratorConfig as JGeneratorConfig
from dispu_tpu.config import InferenceConfig as JInferenceConfig
from dispu_tpu.config import TrainConfig as JTrainConfig
from dispu_tpu.serving import ServedUpsampler as JServedUpsampler
from dispu_tpu.serving import export_upsampler as jexport_upsampler
from dispu_tpu.train.state import create_generator_state as jcreate_state
from dispu_tpu_torch.config import GeneratorConfig, InferenceConfig
from dispu_tpu_torch.inference import PatchUpsampler
from dispu_tpu_torch.serving import ServedUpsampler, export_upsampler

torch.set_num_threads(1)

SMALL = dict(num_points=64, knn=8, refine_nsample=8)
INF = dict(final_ratio=4, patch_num_point=64, patch_batch=4)
GEN = GeneratorConfig(**SMALL)


@pytest.fixture(scope="module")
def variables():
    """``tests/test_serving.py``'s flax init, as numpy."""
    state = jcreate_state(jax.random.PRNGKey(0), JGeneratorConfig(**SMALL),
                          JTrainConfig())
    return jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats})


@pytest.fixture(scope="module")
def artifact(variables, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serving") / "upsampler")
    manifest = export_upsampler(variables, sizes=[200, 128], path=path,
                                gen_cfg=GEN, inf_cfg=InferenceConfig(**INF),
                                device="cpu")
    return path, manifest


@pytest.fixture(scope="module")
def live(variables):
    return PatchUpsampler(variables, gen_cfg=GEN,
                          inf_cfg=InferenceConfig(**INF), device="cpu")


def _cloud(n, seed=0):
    return np.random.RandomState(seed).randn(n, 3).astype(np.float32)


@pytest.mark.parametrize("n", [128, 200])
def test_served_is_live_and_matches_jax_served(n, variables, artifact, live,
                                               tmp_path):
    """Bounds: bit-equal to the live ``upsample``; against JAX's
    ``ServedUpsampler`` on the same variables, ≥ 99% of rows within 1e-3
    and each set within 1e-3 of the other (cloud units, the cloud spans
    ~±3), ``test_upsample_matches_jax``'s bounds and reasons: f32
    round-off of the patches can flip a near-tied kNN pick, and the merge
    FPS can then swap two near-tied picks."""
    path, _ = artifact
    pc = _cloud(n, seed=n)
    got = ServedUpsampler(path).upsample(pc)
    assert got.shape == (n * 4, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, live.upsample(pc))

    jpath = str(tmp_path / "jax")
    jexport_upsampler(variables, sizes=[n], path=jpath,
                      gen_cfg=JGeneratorConfig(**SMALL),
                      inf_cfg=JInferenceConfig(**INF))
    want = JServedUpsampler(jpath).upsample(pc)
    assert want.shape == got.shape
    row_err = np.abs(got - want).max(axis=1)
    assert (row_err <= 1e-3).mean() >= 0.99
    d = np.sum((got[:, None, :] - want[None, :, :]) ** 2, axis=-1)
    assert np.sqrt(d.min(axis=1)).max() <= 1e-3
    assert np.sqrt(d.min(axis=0)).max() <= 1e-3


def test_manifest_fields(artifact):
    path, manifest = artifact
    with open(os.path.join(path, "manifest.json")) as f:
        on_disk = json.load(f)
    # JSON turns the configs' tuples into lists
    assert on_disk == json.loads(json.dumps(manifest))
    assert on_disk["format_version"] == 1
    assert on_disk["kind"] == "dispu_tpu_torch.upsampler"
    assert on_disk["final_ratio"] == 4
    assert on_disk["generator_config"] == json.loads(json.dumps(
        dataclasses.asdict(GEN)))
    assert on_disk["inference_config"]["patch_batch"] == 4
    assert [e["n"] for e in on_disk["entries"]] == [128, 200]
    for e in on_disk["entries"]:
        assert e["out_n"] == e["n"] * 4
        assert e["file"] == f"entry_{e['n']}.pt2"
        assert os.path.exists(os.path.join(path, e["file"]))
        assert e["device"] == "cpu"
        assert e["kernels"] == ["fps", "knn"]
    assert ServedUpsampler(path).sizes == [128, 200]


def test_undeclared_size_raises(artifact):
    served = ServedUpsampler(artifact[0])
    with pytest.raises(ValueError, match="no exported entry for n=77"):
        served.upsample(_cloud(77))


def _copy_with(artifact, tmp_path, **changes):
    path = tmp_path / "edited"
    shutil.copytree(artifact[0], path)
    manifest = json.loads((path / "manifest.json").read_text())
    for key, value in changes.items():
        manifest[key] = value(manifest) if callable(value) else value
    (path / "manifest.json").write_text(json.dumps(manifest))
    return str(path)


def test_wrong_kind_rejected(artifact, tmp_path):
    with pytest.raises(ValueError, match="not an upsampler artifact"):
        ServedUpsampler(_copy_with(artifact, tmp_path,
                                   kind="dispu_tpu.upsampler"))


def test_newer_format_rejected(artifact, tmp_path):
    with pytest.raises(ValueError, match="newer than this loader"):
        ServedUpsampler(_copy_with(artifact, tmp_path, format_version=2))


def test_cuda_entry_never_runs_on_the_cpu(artifact, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = _copy_with(artifact, tmp_path, entries=lambda m: [
        {**e, "device": "cuda"} for e in m["entries"]])
    with pytest.raises(RuntimeError, match="exported for a CUDA device"):
        ServedUpsampler(path).upsample(_cloud(128))


def test_repeat_calls_reuse_the_loaded_entry(artifact):
    served = ServedUpsampler(artifact[0])
    pc = _cloud(128, seed=3)
    a = served.upsample(pc)
    program = served._calls[128]
    b = served.upsample(pc)
    np.testing.assert_array_equal(a, b)
    assert list(served._calls) == [128] and served._calls[128] is program


def test_warmup_loads_every_entry(artifact):
    served = ServedUpsampler(artifact[0])
    served.warmup()  # CPU entries: loads them, builds no kernel
    assert sorted(served._calls) == [128, 200]
    assert served.upsample(_cloud(200)).shape == (800, 3)


def test_mesh_export_at_world_size_one(variables, artifact, tmp_path):
    """The SPMD export on a (1, 1) mesh of a one-process gloo group: the
    entry records ``nr_devices`` 1 and the default group, its graph holds
    the functional all-gather beside the mesh-less entry's ops, and it
    serves bit-equal to the live mesh path and to the mesh-less entry.
    Without the group it does not load.  (World size 2 is
    ``tests/test_torch_parallel.py``'s.)"""
    import torch.distributed as dist

    from dispu_tpu_torch.parallel.mesh import make_mesh

    path, pc = str(tmp_path / "spmd"), _cloud(128, seed=5)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/group",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cpu")
        up = PatchUpsampler(variables, gen_cfg=GEN,
                            inf_cfg=InferenceConfig(**INF), device="cpu",
                            mesh=mesh)
        manifest = export_upsampler(variables, [128], path, gen_cfg=GEN,
                                    inf_cfg=InferenceConfig(**INF),
                                    mesh=mesh, device="cpu")
        entry = manifest["entries"][0]
        assert (entry["nr_devices"], entry["group"]) == (1, "0")
        assert entry["collectives"] == [
            "_c10d_functional::all_gather_into_tensor",
            "_c10d_functional::wait_tensor"]
        assert entry["kernels"] == artifact[1]["entries"][0]["kernels"]
        live = up.upsample(pc)
        served = ServedUpsampler(path)
        served.warmup()
        np.testing.assert_array_equal(served.upsample(pc), live)
        np.testing.assert_array_equal(
            live, ServedUpsampler(artifact[0]).upsample(pc))
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="exported for 1 processes"):
        ServedUpsampler(path)
