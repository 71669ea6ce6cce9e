"""Time edited copies of the kNN kernel's forms side by side on the card.

    python3 -m dispu_tpu_torch.time_knn_forms [--reps 20] [--radix]
                                              [VARIANTS.json]
    python3 -m dispu_tpu_torch.time_knn_forms --regimes

A variant is a copy of ``kernels/csrc`` with literal text replacements in
``knn_common.cuh`` or ``knn.cu`` (each edit where its text is found);
VARIANTS.json holds ``{name: [[old, new], ...]}`` and the built-in ones
are :data:`VARIANTS` (the tiled form) and, with ``--radix``,
:data:`RADIX_VARIANTS` (the radix form past k = 32).  Each copy's
``knn.cu`` is built with ``nvcc`` and the flags of ``kernels/_build.py``
into a temporary directory, loaded with ``ctypes`` and timed on the same
inputs, by CUDA events around ``--reps`` back-to-back calls after two
warm-up calls: the tiled form at every shape of ``measure.KNN_CASES`` with
k <= 32, and with ``--radix`` the radix form at the 4× patch cut and every
shape of ``measure.KNN_WIDE_CASES`` (in the regime ``knn_form`` picks),
there also by the profiler's device time (``kernel_ms``).  Every variant
but the ``no selection`` bound must return the unedited sources' bits,
and the unedited sources' tiled form must equal the radix form's first k
(k' = 33).  Prints the card's name and power limit, each build's
registers, spills and shared memory, and one JSON line a shape with each
variant's ms.

``--regimes`` builds nothing of its own: it times the shipped radix
form's two regimes, ``knn_cuda`` ('row') and ``knn_split_cuda``
('split'), on the same inputs (a scan of n points, ``measure.scan_cloud``
with seed 5, m of them the queries, k 256) at n from 2,048 to the 'row'
regime's largest, by the profiler's device time, their bits held equal:
the measurement behind ``knn_form``'s :data:`~dispu_tpu_torch.kernels.knn.RADIX_ROW_POINTS`.
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
from dispu_tpu_torch.kernels.knn import MAX_STREAM_K, radix_plan
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


#: the radix form's alternatives: one histogram atomic a bin a warp
#: (``__match_any_sync``) instead of one an entry; the coordinates read one
#: float at a time at c % 4 == 0 and c = 3 as a variable; the 'split'
#: regime's points one a step instead of four; while the descent is in
#: the distance's bits, the key alone instead of the 64-bit composite
RADIX_VARIANTS = {
    "one atomic a bin a warp": [[
        "  if (take) atomicAdd(&hist[bin], 1u);",
        "  const unsigned mask = __ballot_sync(kFull, take);\n"
        "  if (take) {\n"
        "    const unsigned peers = __match_any_sync(mask, bin);\n"
        "    if ((threadIdx.x & 31) == __ffs(peers) - 1)\n"
        "      atomicAdd(&hist[bin], __popc(peers));\n"
        "  }"]],
    "any c, one at a time": [["  if (c == 3) return kC3;\n", ""],
                             ["c % 4 == 0 && (reinterpret", "false && (re"
                              "interpret"]],
    "one point a step": [["constexpr int kCloudSteps = 4;",
                          "constexpr int kCloudSteps = 1;"]],
    "key bits alone": [[
        "  return (((unsigned long long)key << r.jb)",
        "  if (bits <= 32) return bits ? key >> (32 - bits) : 0u;\n"
        "  return (((unsigned long long)key << r.jb)"]],
}


def _build_copy(tmp: pathlib.Path, name: str, edits) -> subprocess.Popen:
    src = tmp / name / "csrc"
    shutil.copytree(_build.CSRC, src)
    files = [src / "knn_common.cuh", src / "knn.cu"]
    texts = [f.read_text() for f in files]
    for old, new in edits:
        if not any(old in text for text in texts):
            raise ValueError(f"variant {name!r}: {old!r} not in the sources")
        texts = [text.replace(old, new) for text in texts]
    for f, text in zip(files, texts):
        f.write_text(text)
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


def _time_radix(libs, dev, reps: int) -> None:
    """Each variant's radix form at the 4× patch cut and at
    ``measure.KNN_WIDE_CASES``, in the regime ``knn_form`` picks, bits
    held to the shipped sources'."""
    import numpy as np

    from dispu_tpu_torch.kernels import measure
    from dispu_tpu_torch.kernels.knn import knn_form
    from dispu_tpu_torch.ops.geometry import normalize_point_cloud

    cloud = normalize_point_cloud(torch.from_numpy(np.loadtxt(
        pathlib.Path(__file__).parents[1] / "demo" / "gt" /
        "Icosahedron.xyz", dtype=np.float32)[:, :3]))[0]
    cases = KNN_CASES[:1] + measure.KNN_WIDE_CASES
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for case, (pts, qs) in zip(cases, knn_inputs(
            torch.Generator().manual_seed(1), cases, cloud)):
        pts = pts.to(dev)
        qs = pts if qs is None else qs.to(dev)
        b, n, c = pts.shape
        m, k = qs.shape[1], case.k
        form = knn_form(k, n, c)
        plan = radix_plan(k, n, c, b * m, form)
        d = torch.empty(b, m, k, device=dev)
        j = torch.empty(b, m, k, dtype=torch.int32, device=dev)
        events, device, want = {}, {}, None
        for name, lib in libs.items():
            if form == "row":
                fn = lib.dispu_knn
                fn.argtypes = [p] * 5 + [i] * 6 + [p]
                extra = (plan.threads,)
            else:
                fn = lib.dispu_knn_split
                fn.argtypes = [p] * 5 + [i] * 7 + [p]
                extra = (plan.threads, plan.cap)
            fn.restype = i

            def run(name=name, fn=fn, extra=extra):
                _build.check(fn(pts.data_ptr(), qs.data_ptr(), None,
                                d.data_ptr(), j.data_ptr(), b, n, m, c, k,
                                *extra, stream), f"{name} at {case.label}")

            run()
            got = (d.clone(), j.clone())
            if want is None:
                want = got
            elif not (torch.equal(got[0], want[0])
                      and torch.equal(got[1], want[1])):
                raise SystemExit(f"{case.label}: {name} changes the bits")
            events[name] = _timed(run, reps)
            device[name] = measure.device_ms(run, reps)
        print(json.dumps({"shape": case.label, "form": form,
                          "threads": plan.threads, "ms": events,
                          "kernel_ms": device}), flush=True)


def _time_regimes(reps: int) -> None:
    from dispu_tpu_torch.inference import pin_f32
    from dispu_tpu_torch.kernels import measure
    from dispu_tpu_torch.kernels.knn import (RADIX_ROW_FLOATS, knn_cuda,
                                             knn_split_cuda)

    pin_f32()
    for n in (2048, 4096, 8192, 16384, 32768, RADIX_ROW_FLOATS - 3):
        pts = measure.scan_cloud(n, 5)[None].cuda()
        for m in (24, 256, 703):
            pick = torch.randperm(n, generator=torch.Generator().manual_seed(m))
            qs = pts[:, pick[:m]].contiguous()
            row = knn_cuda(256, pts, qs)
            split = knn_split_cuda(256, pts, qs)
            if not (torch.equal(row[0], split[0])
                    and torch.equal(row[1], split[1])):
                raise SystemExit(f"n={n} m={m}: the regimes differ")
            print(json.dumps({"n": n, "m": m, "k": 256, "kernel_ms": {
                "row": measure.device_ms(lambda: knn_cuda(256, pts, qs),
                                         reps),
                "split": measure.device_ms(
                    lambda: knn_split_cuda(256, pts, qs), reps)}}),
                flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("variants", nargs="?")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--radix", action="store_true",
                        help="the radix form past k = 32 instead of the "
                             "tiled form")
    parser.add_argument("--regimes", action="store_true",
                        help="time the radix form's 'row' and 'split' "
                             "regimes against each other")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_knn_forms: no CUDA device is available", file=sys.stderr)
        return 1
    variants = {"shipped": [],
                **(RADIX_VARIANTS if args.radix else VARIANTS)}
    if args.variants:
        variants.update(json.loads(pathlib.Path(args.variants).read_text()))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0],
        flush=True)
    if args.regimes:
        _time_regimes(args.reps)
        return 0

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
            # ptxas reports the kernels in source order; keep the timed ones
            lines = out.splitlines()
            for kernel in (("knn_radix_row_kernel", "knn_radix_cloud_kernel")
                           if args.radix else ("knn_stream_kernel",)):
                at = next(i for i, line in enumerate(lines)
                          if kernel in line and "Compiling" in line)
                print(json.dumps({"variant": name, "kernel": kernel,
                                  "ptxas": [
                    line.strip() for line in lines[at + 1:at + 4]
                    if "spill" in line or "registers" in line]}),
                    flush=True)
            libs[name] = ctypes.CDLL(str(tmp / name / "knn.so"))

        dev = torch.device("cuda")
        if args.radix:
            _time_radix(libs, dev, args.reps)
            return 0
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
                fn.argtypes = [p] * 5 + [i] * 6 + [p]
                fn.restype = i

                def run(k, name=name, fn=fn):
                    d, j = out[k]
                    threads = (radix_plan(k, n, c, b * m, "row").threads
                               if k > MAX_STREAM_K else 0)
                    status = fn(pts.data_ptr(), qs.data_ptr(),
                                bias.data_ptr(), d.data_ptr(), j.data_ptr(),
                                b, n, m, c, k, threads, stream)
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
                                         "differs from the radix form")
                elif name != "no selection" and not (
                        torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise SystemExit(f"{case.label}: {name} changes the bits")
                row[name] = _timed(lambda: run(case.k), args.reps)
            print(json.dumps({"shape": case.label, "ms": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
