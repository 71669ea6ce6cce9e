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

    python -m dispu_tpu_torch.cli --phase export --log_dir log \\
        --test_data 'data/test/*.xyz'
    ServedUpsampler("log/export").upsample(cloud)
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


def graph_ops(program) -> list:
    """The kernels' custom ops (``kernels.OPS``) that an exported program
    calls, sorted by name."""
    names = {node.target._schema.name
             for gm in program.graph_module.modules()
             if isinstance(gm, torch.fx.GraphModule)
             for node in gm.graph.nodes
             if isinstance(node.target, torch._ops.OpOverload)}
    return sorted(op for op in kernels.OPS
                  if f"dispu_tpu_torch::{op}" in names)


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
    default).  mesh: multi-device export is not ported and raises.

    Writes ``entry_<n>.pt2`` for each size and ``manifest.json``, and
    returns the manifest: the JAX package's fields, with ``device`` and
    ``kernels`` (the custom ops in the entry's graph) in each entry in
    place of ``platforms`` and ``nr_devices``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "multi-device export is not ported yet (ROADMAP.md, queue 1, "
            "item 19b: SPMD export)")
    from dispu_tpu_torch.inference import PatchUpsampler

    flax_tree = variables is not None and "params" in variables
    up = PatchUpsampler(variables if flax_tree else None, gen_cfg=gen_cfg,
                        inf_cfg=inf_cfg, device=device)
    if variables is not None and not flax_tree:
        up.model.load_state_dict(variables)
    entry = _Entry(up)
    os.makedirs(path, exist_ok=True)
    entries = []
    for n in sorted(set(int(s) for s in sizes)):
        with torch.no_grad():
            program = torch.export.export(
                entry, (torch.zeros((n, 3), device=up.device),))
        fname = f"entry_{n}.pt2"
        torch.export.save(program, os.path.join(path, fname))
        entries.append({"n": n, "out_n": n * inf_cfg.final_ratio,
                        "file": fname, "device": up.device.type,
                        "kernels": graph_ops(program)})
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


class ServedUpsampler:
    """A loaded artifact: each entry loaded once, called per cloud, with
    f32 products kept in f32 as in live requests (``kernels.pin_f32``)."""

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
        self._calls: Dict[int, tuple] = {}

    @property
    def sizes(self):
        return sorted(self._entries)

    def _call_for(self, n: int):
        """(the loaded program of the n-point entry, its device)."""
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
            self._calls[n] = (program.module(), device)
        return self._calls[n]

    def warmup(self, sizes=None):
        """Load the entries ahead of traffic and build (``nvcc``) the
        kernel libraries that the CUDA entries' graphs call; launches
        nothing."""
        from dispu_tpu_torch.kernels import _build

        sizes = self.sizes if sizes is None else sizes
        for n in sizes:
            self._call_for(n)
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
        fn, device = self._call_for(pc.shape[0])
        with torch.inference_mode():
            return fn(torch.from_numpy(pc).to(device)).cpu().numpy()
