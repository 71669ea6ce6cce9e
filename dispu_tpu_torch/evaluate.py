"""Metrics command line of the port: score predicted clouds against ground
truth (the twin of ``evaluate.py``, the same flags and summary).

Per file CD / hausdorff / p2f avg / p2f std / uniform_{0,1} plus a summary
row, written to evaluation.csv next to the predictions; P2F and the
geodesic-disk uniformity need a ``--mesh`` directory of ``<name>.off``
files.  ``--device`` (default ``cuda``) is the port's own; ``--device
cpu`` runs the kernels' plain versions.

    python -m dispu_tpu_torch.evaluate --pred outputs/ --gt data/test/gt/ \\
        [--mesh data/test/] [--device cpu]
"""

import argparse
import json


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pred", required=True, help="dir of predicted *.xyz")
    p.add_argument("--gt", required=True, help="dir of ground-truth *.xyz")
    p.add_argument("--mesh", default=None, help="dir of gt *.off meshes")
    p.add_argument("--out_csv", default=None)
    p.add_argument("--disk_seeds", type=int, default=1000)
    p.add_argument(
        "--dump_p2f", action="store_true",
        help="also write the reference evaluation binary's per-point side "
        "files next to each prediction: <name>_point2mesh_distance.txt, "
        "_disk_idx.txt, _radius.txt, _sampling_seed.txt")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args()

    from dispu_tpu_torch.evaluation.report import evaluate_dirs

    summary = evaluate_dirs(
        args.pred,
        args.gt,
        mesh_dir=args.mesh,
        out_csv=args.out_csv,
        num_disk_seeds=args.disk_seeds,
        dump_p2f=args.dump_p2f,
        device=args.device,
    )
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
