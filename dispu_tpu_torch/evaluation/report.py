"""Directory-level evaluation producing evaluation.csv (counterpart of
``evaluation/report.py``).

Per file CD / hausdorff / p2f avg / p2f std / uniform_{0,1}, plus a summary
row of averages, in the JAX package's CSV schema.  P2F and the geodesic
disks' uniformity are computed when a gt mesh (.off) is given.  CD/HD and
the point-to-face scan run on ``device`` (the card by default) with f32
products pinned (``inference.pin_f32``), so no TF32 product reaches an
argmin; the geodesic distances and the uniformity are host numpy, as in
the JAX package.
"""

from __future__ import annotations

import csv
import math
import os
from glob import glob
from typing import Optional

import numpy as np
import torch

from dispu_tpu_torch.evaluation.meshio import (
    mesh_face_areas,
    read_off,
    read_xyz,
    sample_mesh_surface,
)
from dispu_tpu_torch.evaluation.metrics import (
    cd_hd,
    geodesic_distances,
    point_to_mesh_distance,
    uniformity_measure,
)
from dispu_tpu_torch.inference import pin_f32, resolve_device

PERCENTAGES = (0.008, 0.012)  # the disk areas' shares of the mesh's
NUM_DISK_SEEDS = 1000         # the CGAL binary's sample_number


def _dump_side_files(
    prefix: str,
    pred: np.ndarray,
    p2f: np.ndarray,
    mapped: np.ndarray,
    verts: np.ndarray,
    faces: np.ndarray,
    seeds: np.ndarray,
    seed_faces: np.ndarray,
    radii,
    seed_point_dists: np.ndarray,
) -> None:
    """Write the reference evaluation binary's per-point side files.

    Formats (the ones Dis-PU's ``evaluate.py`` reads in
    ``analyze_uniform``):

    * ``<prefix>_point2mesh_distance.txt`` — one line per predicted point:
      ``px py pz dist mx my mz`` (the point, its point-to-face distance,
      and the mapped on-surface point).
    * ``<prefix>_radius.txt`` — the disk radii √(area·p/π), space-joined
      on one line.
    * ``<prefix>_disk_idx.txt`` — ``n_seeds × n_radii`` lines in
      seed-major order (line ``i·n_radii + j`` is seed i, radius j):
      ``<count>:<idx0> <idx1> ... `` — the predicted-point indices whose
      on-surface distance to the seed is ≤ the radius.
    * ``<prefix>_sampling_seed.txt`` — the seeds' barycentric coordinates
      in their faces, tab-joined (written by the binary but consumed by
      nothing — kept for format parity).
    """
    np.savetxt(
        prefix + "_point2mesh_distance.txt",
        np.concatenate(
            [pred[:, :3], np.asarray(p2f)[:, None], mapped[:, :3]], axis=1
        ),
        fmt="%g",
    )
    with open(prefix + "_radius.txt", "w") as f:
        f.write("".join("%g " % r for r in radii) + "\n")
    dists = np.asarray(seed_point_dists)
    with open(prefix + "_disk_idx.txt", "w") as f:
        for i in range(len(seeds)):
            for r in radii:
                members = np.nonzero(dists[i] <= r)[0]
                f.write(
                    "%d:" % len(members)
                    + "".join("%d " % m for m in members)
                    + "\n"
                )
    # barycentric coordinates of each seed inside its face
    tri = np.asarray(verts, np.float64)[np.asarray(faces)[
        np.asarray(seed_faces, np.int64)]]
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    v0, v1, v2 = b - a, c - a, np.asarray(seeds, np.float64) - a
    d00 = np.sum(v0 * v0, 1)
    d01 = np.sum(v0 * v1, 1)
    d11 = np.sum(v1 * v1, 1)
    d20 = np.sum(v2 * v0, 1)
    d21 = np.sum(v2 * v1, 1)
    denom = np.maximum(d00 * d11 - d01 * d01, 1e-30)
    lb = (d11 * d20 - d01 * d21) / denom
    lc = (d00 * d21 - d01 * d20) / denom
    bary = np.stack([1.0 - lb - lc, lb, lc], axis=1)
    with open(prefix + "_sampling_seed.txt", "w") as f:
        for row in bary:
            f.write("%g\t%g\t%g\n" % tuple(row))


def evaluate_pair(
    pred_path: str,
    gt_path: str,
    mesh_path: Optional[str] = None,
    num_disk_seeds: int = NUM_DISK_SEEDS,
    geodesic: bool = True,
    dump_p2f: bool = False,
    device="cuda",
) -> dict:
    """One prediction's CSV row (plus its per-point P2F under ``_p2f``);
    with ``dump_p2f`` also the binary's side files next to it."""
    dev = resolve_device(device)
    pin_f32()
    pred = read_xyz(pred_path)[:, :3]
    gt = read_xyz(gt_path)[:, :3]
    cd, hd = cd_hd(torch.from_numpy(pred).to(dev),
                   torch.from_numpy(gt).to(dev))
    row = {
        "name": os.path.basename(pred_path),
        "CD": float(cd),
        "hausdorff": float(hd),
    }
    if mesh_path and os.path.isfile(mesh_path):
        verts, faces = read_off(mesh_path)
        d, mapped, point_faces = point_to_mesh_distance(
            pred, verts, faces, return_faces=True, device=dev
        )
        row["p2f avg"] = float(np.nanmean(d))
        row["p2f std"] = float(np.nanstd(d))
        row["_p2f"] = d
        area = float(mesh_face_areas(verts, faces).sum())
        seeds, seed_faces = sample_mesh_surface(
            verts, faces, num_disk_seeds, return_faces=True
        )
        dists = (
            geodesic_distances(
                verts, faces, seeds, seed_faces, mapped, point_faces
            )
            if geodesic
            else None
        )
        uni = uniformity_measure(
            mapped, area, seeds, PERCENTAGES, seed_point_dists=dists
        )
        for i in range(len(PERCENTAGES)):
            row["uniform_%d" % i] = float(uni[i, 0])
        if dump_p2f:
            if dists is None:  # euclidean disks — same membership metric
                dists = np.sqrt(
                    np.sum(
                        (seeds[:, None, :] - mapped[None, :, :]) ** 2, -1
                    )
                )
            _dump_side_files(
                pred_path[:-4], pred, d, mapped, verts, faces, seeds,
                seed_faces,
                [math.sqrt(area * p / math.pi) for p in PERCENTAGES],
                dists,
            )
    return row


def evaluate_dirs(
    pred_dir: str,
    gt_dir: str,
    mesh_dir: Optional[str] = None,
    out_csv: Optional[str] = None,
    num_disk_seeds: int = NUM_DISK_SEEDS,
    geodesic: bool = True,
    dump_p2f: bool = False,
    device="cuda",
) -> dict:
    """Evaluate all *.xyz in pred_dir against same-named gt files (a
    prediction '<name>_X4.xyz' pairs with '<name>.xyz' and, in
    ``mesh_dir``, '<name>.off').

    Returns the summary row; writes evaluation.csv next to the predictions
    (or to ``out_csv``), the JAX package's schema.
    """
    dev = resolve_device(device)
    fieldnames = ["name", "CD", "hausdorff", "p2f avg", "p2f std"] + [
        "uniform_%d" % d for d in range(len(PERCENTAGES))
    ]
    gt_paths = {
        os.path.basename(p)[:-4]: p for p in glob(os.path.join(gt_dir, "*.xyz"))
    }
    rows, p2f_all = [], []
    for pred_path in sorted(glob(os.path.join(pred_dir, "*.xyz"))):
        name = os.path.basename(pred_path)[:-4]
        base = name.split("_X")[0]  # pred files are '<name>_X4.xyz'
        gt_path = gt_paths.get(name) or gt_paths.get(base)
        if gt_path is None:
            continue
        mesh_path = None
        if mesh_dir:
            cand = os.path.join(mesh_dir, base + ".off")
            mesh_path = cand if os.path.isfile(cand) else None
        row = evaluate_pair(pred_path, gt_path, mesh_path, num_disk_seeds,
                            geodesic=geodesic, dump_p2f=dump_p2f,
                            device=dev)
        if "_p2f" in row:
            p2f_all.append(row.pop("_p2f"))
        rows.append(row)

    summary = {
        "CD": float(np.mean([r["CD"] for r in rows])) if rows else float("nan"),
        "hausdorff": float(np.mean([r["hausdorff"] for r in rows]))
        if rows
        else float("nan"),
    }
    if p2f_all:
        cat = np.concatenate(p2f_all)
        summary["p2f avg"] = float(np.nanmean(cat))
        summary["p2f std"] = float(np.nanstd(cat))
    for i in range(len(PERCENTAGES)):
        vals = [r.get("uniform_%d" % i) for r in rows if "uniform_%d" % i in r]
        if vals:
            summary["uniform_%d" % i] = float(np.mean(vals))

    out_csv = out_csv or os.path.join(pred_dir, "evaluation.csv")
    with open(out_csv, "w", newline="") as f:
        writer = csv.DictWriter(
            f, fieldnames=fieldnames, restval="-", extrasaction="ignore"
        )
        writer.writeheader()
        for row in rows:
            writer.writerow(row)
        writer.writerow(summary)
    return summary
