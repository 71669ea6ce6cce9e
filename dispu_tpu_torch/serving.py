"""Export and serve the whole-cloud upsampler (counterpart of
``serving.py``).

:func:`export_upsampler` packs the whole computation of
:meth:`~dispu_tpu_torch.inference.PatchUpsampler.pipeline`, normalize →
FPS seeds → kNN patches → chunked generator → merge FPS → un-normalize,
into one ``torch.export`` program for each declared input size, with the
generator's weights inside, saved as ``entry_<n>.pt2`` beside a
``manifest.json``.  Shapes are static per entry, as in the JAX package;
serving an undeclared size raises.

The kernels of the path are ``torch.library`` custom ops
(``dispu_tpu_torch::<name>``, ``kernels.OPS``), each one node of the
graph, so a loaded program launches the hand-written kernels themselves
and counts their launches (``kernels.launch_counts``).  An entry runs on
the device that traced it: one exported on the card holds its weights
there and never runs on the CPU; one exported on the CPU runs the
kernels' plain versions.

:class:`ServedUpsampler` needs torch and the op registrations under
``kernels/`` only: none of the model code (``models/``, ``nn/``,
``inference``, ``convert``) is imported to load and call an artifact.

The SPMD form (``mesh=``): the program of ``PatchUpsampler(mesh=...)``,
in which each process runs its rows of every chunk of patches and one
all-gather over the mesh's data axis brings every process all of them.
The gather is a functional collective (``parallel.mesh.all_gather_rows``),
so the graph holds it as ``_c10d_functional`` nodes with the name of the
data axis's group, which must be the default group (a (world, 1) mesh's
data axis is the whole world).  Which rows a process runs depends on its
rank, and anything read from Python while tracing is a constant of the
program; so the rank is an input of the program, ``entry(pc, rank)``,
and not a constant of one program a process: every process loads the
same file and passes its own rank, the weights are stored once, as in
the JAX package's one SPMD program, and a launch serves whatever rank
order its launcher gives.  Each entry records ``nr_devices`` (the data
axis's size) and its ``group``; :class:`ServedUpsampler` serves it only
in a default process group of exactly that size, at any size including
1, where the collective still runs.  Every process of the group must
call ``upsample`` with the same cloud.

    python -m dispu_tpu_torch.cli --phase export --log_dir log \\
        --test_data 'data/test/*.xyz'
    ServedUpsampler("log/export").upsample(cloud)

    # SPMD, in each process of a torchrun launch of W processes:
    mesh = parallel.make_mesh(device=...)
    export_upsampler(state_dict, sizes, path, mesh=mesh, device=...)
    ServedUpsampler(path).upsample(cloud)   # in a group of W processes
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Sequence

import numpy as np
import torch

from dispu_tpu_torch import kernels
from dispu_tpu_torch.config import GeneratorConfig, InferenceConfig

_MANIFEST = "manifest.json"
_FORMAT_VERSION = 1
KIND = "dispu_tpu_torch.upsampler"


class _Entry(torch.nn.Module):
    """The (n, 3) → (n·final_ratio, 3) serving function of one cloud, the
    generator (and so its weights) inside."""

    def __init__(self, up):
        super().__init__()
        self.model = up.model
        self._pipeline = up.pipeline

    def forward(self, pc: torch.Tensor) -> torch.Tensor:
        return self._pipeline(pc[None])[0]


class _MeshEntry(_Entry):
    """The SPMD serving function: the cloud and this process's data rank
    (a 0-d int64 tensor) → the whole output, in every process."""

    def forward(self, pc: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
        return self._pipeline(pc[None], rank)[0]


def _op_names(program) -> set:
    """The qualified names of the ops that an exported program calls."""
    return {node.target._schema.name
            for gm in program.graph_module.modules()
            if isinstance(gm, torch.fx.GraphModule)
            for node in gm.graph.nodes
            if isinstance(node.target, torch._ops.OpOverload)}


def graph_ops(program) -> list:
    """The kernels' custom ops (``kernels.OPS``) that an exported program
    calls, sorted by name."""
    names = _op_names(program)
    return sorted(op for op in kernels.OPS
                  if f"dispu_tpu_torch::{op}" in names)


def graph_collectives(program) -> list:
    """The ``_c10d_functional`` ops (collectives and their waits) that an
    exported program calls, sorted by name."""
    return sorted(name for name in _op_names(program)
                  if name.startswith("_c10d_functional::"))


def _default_group_of(mesh) -> str:
    """The name of the mesh's data-axis group, which the traced collective
    names; it must be the default group's, the one name that a fresh
    launch gives the same group."""
    import torch.distributed as dist

    name = mesh.get_group(0).group_name
    if name != dist.group.WORLD.group_name:
        raise ValueError(
            f"the mesh's data axis (group {name!r}) is not the default "
            f"process group ({dist.group.WORLD.group_name!r}); an SPMD "
            "entry gathers over the default group")
    return name


def export_upsampler(
    variables,
    sizes: Sequence[int],
    path: str,
    gen_cfg: GeneratorConfig = GeneratorConfig(),
    inf_cfg: InferenceConfig = InferenceConfig(),
    mesh=None,
    device="cuda",
) -> Dict[str, object]:
    """Export the upsampler for each input size in ``sizes`` into ``path``.

    variables: the generator's weights, as ``PatchUpsampler`` takes them
    (a flax ``{'params', 'batch_stats'}`` tree, or None for the port's
    seeded init) or as a ``state_dict`` (what the CLI restores from a
    checkpoint).  device: where the entries trace and will run ('cuda' by
    default).  mesh: a mesh of ``parallel.make_mesh``, to export the SPMD
    form (module docstring); every process of the mesh calls this, rank 0
    traces and writes, and the others wait for it and read its manifest,
    or raise where rank 0 failed.

    Writes ``entry_<n>.pt2`` for each size and ``manifest.json``, and
    returns the manifest: the JAX package's fields (``nr_devices``, 1
    without a mesh), with ``device`` and ``kernels`` (the custom ops in
    the entry's graph) in each entry in place of ``platforms``, and for
    the SPMD form ``group`` and ``collectives`` (its ``_c10d_functional``
    ops).
    """
    if mesh is None:
        return _export(variables, sizes, path, gen_cfg, inf_cfg, None,
                       device)
    from dispu_tpu_torch.parallel.mesh import broadcast_, is_writer

    _default_group_of(mesh)  # every process refuses such a mesh alike
    # rank 0 tells the others whether it wrote the files: a manifest that
    # an earlier export left in ``path`` is no sign of this one's success
    done = torch.zeros(1, dtype=torch.int32, device=mesh.device_type)
    if is_writer(mesh):
        try:
            manifest = _export(variables, sizes, path, gen_cfg, inf_cfg,
                               mesh, device)
            done += 1
        finally:
            broadcast_([done], mesh)
        return manifest
    broadcast_([done], mesh)
    if not done.item():
        raise RuntimeError(
            f"the export into {path} failed in the process that writes it "
            "(data rank 0); its error says why")
    with open(os.path.join(path, _MANIFEST)) as f:
        return json.load(f)


def _export(variables, sizes, path, gen_cfg, inf_cfg, mesh, device):
    """:func:`export_upsampler`'s tracing and writing, in one process."""
    from dispu_tpu_torch.inference import PatchUpsampler
    from dispu_tpu_torch.parallel.mesh import data_size

    flax_tree = variables is not None and "params" in variables
    up = PatchUpsampler(variables if flax_tree else None, gen_cfg=gen_cfg,
                        inf_cfg=inf_cfg, device=device, mesh=mesh)
    if variables is not None and not flax_tree:
        up.model.load_state_dict(variables)
    entry = _Entry(up) if mesh is None else _MeshEntry(up)
    os.makedirs(path, exist_ok=True)
    entries = []
    for n in sorted(set(int(s) for s in sizes)):
        args = (torch.zeros((n, 3), device=up.device),)
        if mesh is not None:
            args += (torch.zeros((), dtype=torch.int64, device=up.device),)
        with torch.no_grad():
            program = torch.export.export(entry, args)
        fname = f"entry_{n}.pt2"
        torch.export.save(program, os.path.join(path, fname))
        record = {"n": n, "out_n": n * inf_cfg.final_ratio, "file": fname,
                  "device": up.device.type, "kernels": graph_ops(program),
                  "nr_devices": 1 if mesh is None else data_size(mesh)}
        if mesh is not None:
            record["group"] = _default_group_of(mesh)
            record["collectives"] = graph_collectives(program)
        entries.append(record)
    manifest = {
        "format_version": _FORMAT_VERSION,
        "kind": KIND,
        "final_ratio": inf_cfg.final_ratio,
        "generator_config": dataclasses.asdict(gen_cfg),
        "inference_config": dataclasses.asdict(inf_cfg),
        "entries": entries,
    }
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def _spmd_group(entry):
    """None for an entry without a mesh; for an SPMD entry the default
    process group, after checking that it exists and holds exactly the
    entry's ``nr_devices`` processes under the name the graph's collective
    carries (``ValueError`` naming both counts otherwise: an SPMD entry
    never serves in one process alone)."""
    if entry.get("group") is None:
        return None
    import torch.distributed as dist

    n, want = entry["n"], int(entry["nr_devices"])
    if not dist.is_initialized():
        raise ValueError(
            f"entry n={n} was exported for {want} processes (SPMD) and this "
            "process is in no process group (0 processes): start "
            f"{want} processes (torchrun --nproc_per_node {want}) and "
            "initialise the default group before loading")
    world = dist.get_world_size()
    if world != want:
        raise ValueError(
            f"entry n={n} was exported for {want} processes (SPMD); the "
            f"default process group has {world}")
    if dist.group.WORLD.group_name != entry["group"]:
        raise ValueError(
            f"entry n={n} gathers over group {entry['group']!r}; the "
            f"default group is named {dist.group.WORLD.group_name!r}")
    return dist.group.WORLD


class ServedUpsampler:
    """A loaded artifact: each entry loaded once, called per cloud, with
    f32 products kept in f32 as in live requests (``kernels.pin_f32``).
    An SPMD artifact (``nr_devices``, ``group``) loads only in a default
    process group of its size (:func:`_spmd_group`), and each of its
    processes passes its rank to the program."""

    def __init__(self, path: str):
        kernels.pin_f32()
        with open(os.path.join(path, _MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("kind") != KIND:
            raise ValueError(f"{path} is not an upsampler artifact")
        if self.manifest["format_version"] > _FORMAT_VERSION:
            raise ValueError(
                "artifact format %s is newer than this loader (%s)"
                % (self.manifest["format_version"], _FORMAT_VERSION))
        self._path = path
        self._entries = {e["n"]: e for e in self.manifest["entries"]}
        self._groups = {n: _spmd_group(e) for n, e in self._entries.items()}
        self._calls: Dict[int, tuple] = {}

    @property
    def sizes(self):
        return sorted(self._entries)

    def _call_for(self, n: int):
        """(the loaded program of the n-point entry, its device, its extra
        arguments: this process's rank for an SPMD entry)."""
        if n not in self._calls:
            if n not in self._entries:
                raise ValueError(
                    f"no exported entry for n={n}; artifact has "
                    f"{self.sizes} (re-export with this size included)")
            entry = self._entries[n]
            device = torch.device(entry["device"])
            if device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    f"entry n={n} was exported for a CUDA device and none "
                    "is available; an entry runs only where it was "
                    "exported")
            kernels.register_ops()
            program = torch.export.load(
                os.path.join(self._path, entry["file"]))
            extra = ()
            if self._groups[n] is not None:
                import torch.distributed as dist

                extra = (torch.tensor(dist.get_rank(self._groups[n]),
                                      dtype=torch.int64, device=device),)
            self._calls[n] = (program.module(), device, extra)
        return self._calls[n]

    def warmup(self, sizes=None):
        """Load the entries ahead of traffic and build (``nvcc``) the
        kernel libraries that the CUDA entries' graphs call; for SPMD
        entries, one all-gather of one element over their group, which
        creates NCCL's communicator, else made inside the first request.
        Launches none of the kernels."""
        from dispu_tpu_torch.kernels import _build

        sizes = self.sizes if sizes is None else sizes
        for n in sizes:
            _, device, extra = self._call_for(n)
            if extra:
                group = self._groups[n]
                torch.ops._c10d_functional.wait_tensor(
                    torch.ops._c10d_functional.all_gather_into_tensor(
                        torch.zeros(1, device=device), group.size(),
                        group.group_name))
        names = sorted({kernels.OPS[op] for n in sizes
                        if self._entries[n]["device"] == "cuda"
                        for op in self._entries[n]["kernels"]})
        _build.build(names)
        for name in names:
            _build.load(name)

    def upsample(self, pc: np.ndarray) -> np.ndarray:
        """(n, 3) cloud → (n·final_ratio, 3); n must be an exported
        size."""
        pc = np.asarray(pc, np.float32)[:, :3]
        fn, device, extra = self._call_for(pc.shape[0])
        with torch.inference_mode():
            return fn(torch.from_numpy(pc).to(device), *extra).cpu().numpy()
