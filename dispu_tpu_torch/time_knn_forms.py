"""Time edited copies of the tiled kNN form side by side on the card.

    python3 -m dispu_tpu_torch.time_knn_forms [--reps 20] [VARIANTS.json]

A variant is a copy of ``kernels/csrc`` with literal text replacements in
``knn_common.cuh``; VARIANTS.json holds ``{name: [[old, new], ...]}`` and
the built-in ones are :data:`VARIANTS`.  Each copy's ``knn.cu`` is built
with ``nvcc`` and the flags of ``kernels/_build.py`` into a temporary
directory, loaded with ``ctypes`` and timed on the same inputs at every
shape of ``measure.KNN_CASES`` with k <= 32, by CUDA events around
``--reps`` back-to-back calls after two warm-up calls.  Every variant but
the ``no selection`` bound must return the unedited sources' bits, and
the unedited sources' must equal the row form's first k (k' = 33).
Prints the card's name and power limit, each build's registers, spills
and shared memory, and one JSON line a shape with each variant's ms.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile

import torch

from dispu_tpu_torch.kernels import _build
from dispu_tpu_torch.kernels.measure import KNN_CASES, knn_inputs
from dispu_tpu_torch.ops.knn import mask_duplicate_rows

#: the tile shapes around the shipped one (4 warps, a lane 4 points, up to
#: 4 tiles and 60 coordinate rows a load), and a bound with the selection
#: cut out: no pair is ever inserted (its output is not the kNN)
VARIANTS = {
    "one tile a load": [["constexpr int kG = 4;", "constexpr int kG = 1;"]],
    "2 warps": [["constexpr int kTileWarps = 4;",
                 "constexpr int kTileWarps = 2;"]],
    "2 points a lane": [["constexpr int kRP = 4;", "constexpr int kRP = 2;"]],
    "8 warps, 32 rows": [
        ["constexpr int kTileWarps = 4;", "constexpr int kTileWarps = 8;"],
        ["constexpr int kCC = 60;", "constexpr int kCC = 32;"]],
    "no selection": [["if (mask == 0) continue;",
                      "if (mask != 0x12345678u) continue;"]],
}


def _build_copy(tmp: pathlib.Path, name: str, edits) -> subprocess.Popen:
    src = tmp / name / "csrc"
    shutil.copytree(_build.CSRC, src)
    header = src / "knn_common.cuh"
    text = header.read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"variant {name!r}: {old!r} not in the header")
        text = text.replace(old, new)
    header.write_text(text)
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp / name / "knn.so"),
         str(src / "knn.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _timed(call, reps: int) -> float:
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("variants", nargs="?")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_knn_forms: no CUDA device is available", file=sys.stderr)
        return 1
    variants = {"shipped": [], **VARIANTS}
    if args.variants:
        variants.update(json.loads(pathlib.Path(args.variants).read_text()))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0],
        flush=True)

    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = pathlib.Path(tmp_name)
        procs = {name: _build_copy(tmp, name, edits)
                 for name, edits in variants.items()}
        libs = {}
        for name, proc in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                print(f"{name}: nvcc failed\n{out}", file=sys.stderr)
                return 1
            # ptxas reports the kernels in source order; keep the tiled one
            lines = out.splitlines()
            at = next(i for i, line in enumerate(lines)
                      if "knn_stream_kernel" in line and "Compiling" in line)
            print(json.dumps({"variant": name, "ptxas": [
                line.strip() for line in lines[at + 1:at + 4]
                if "spill" in line or "registers" in line]}), flush=True)
            libs[name] = ctypes.CDLL(str(tmp / name / "knn.so"))

        dev = torch.device("cuda")
        cases = [case for case in KNN_CASES if case.k <= 32]
        p, i = ctypes.c_void_p, ctypes.c_int
        stream = torch.cuda.current_stream().cuda_stream
        for case, (pts, qs) in zip(cases, knn_inputs(
                torch.Generator().manual_seed(1), cases)):
            pts = pts.to(dev)
            qs = pts if qs is None else qs.to(dev)
            b, n, c = pts.shape
            m = qs.shape[1]
            bias = (mask_duplicate_rows(pts).float() * 1e30 if case.dup
                    else torch.zeros(b, n, device=dev))
            out = {k: (torch.empty(b, m, k, device=dev),
                       torch.empty(b, m, k, dtype=torch.int32, device=dev))
                   for k in (case.k, 33)}
            row, want = {}, None
            for name, lib in libs.items():
                fn = lib.dispu_knn
                fn.argtypes = [p] * 5 + [i] * 5 + [p]
                fn.restype = i

                def run(k, name=name, fn=fn):
                    d, j = out[k]
                    status = fn(pts.data_ptr(), qs.data_ptr(),
                                bias.data_ptr(), d.data_ptr(), j.data_ptr(),
                                b, n, m, c, k, stream)
                    _build.check(status, f"{name} at {case.label}")
                    return d, j

                got = [t.clone() for t in run(case.k)]
                torch.cuda.synchronize()
                if want is None:
                    want = got
                    rd, rj = run(33)
                    if not (torch.equal(got[0], rd[..., :case.k])
                            and torch.equal(got[1], rj[..., :case.k])):
                        raise SystemExit(f"{case.label}: the tiled form "
                                         "differs from the row form")
                elif name != "no selection" and not (
                        torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise SystemExit(f"{case.label}: {name} changes the bits")
                row[name] = _timed(lambda: run(case.k), args.reps)
            print(json.dumps({"shape": case.label, "ms": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
