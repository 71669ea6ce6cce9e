"""The numbers that decide ``correct``: what the timed path produced, held
against the plain reference (``port_bench/reference``) that recomputes it.

Serving (per checked request, then over the checked requests):

* ``norm_off``, ``seed_off``: the normalized cloud bit-equal to the
  reference's, and every seed the farthest point sampling pick
  (``reference.ops.fps_rounds_off``); exact, limit 0;
* ``patch_gap``: the patch cut's excess, the largest squared distance of
  a point the program put in a seed's patch less the smallest of a point
  it left out, by the reference's distances (0 for an exact kNN; near
  ties reach round-off);
* ``pass<i>_err``: the 99th percentile over rows of |program − reference|
  (patch units) of generator pass i, the reference run on the program's
  input to that pass, which for pass 1 is the reference's own
  normalization of the points the program cut;
* ``pass<i>_over``: the share of those rows whose error passes
  ``ROW_TOL`` (1e-4 patch units), so that a fault in fewer rows than the
  percentile leaves out still counts;
* ``merge_off``: the merge's candidates bit-equal to the reference's
  un-normalization of the generator's output, every merged point one of
  them, and every pick FPS's; exact, limit 0;
* ``out_off``: the answer bit-equal to the merged points un-normalized.

Training (the first ``warm_steps`` steps, which set-up drives through the
window's own call and feed, enqueued as the window enqueues them; the
window's later steps are not compared):

* ``loss_gap``: each step's losses (the generator's total, the critic's)
  against the reference's, relative; ``uniform_gap`` the same of the
  logged ``uniform`` metric of a GAN step, whose disks take points by a
  radius test that round-off flips at the boundary;
* ``grad_gap``: per leaf, the gap of the norms of the first gradient
  (from Adam's first moment after one step) over the larger of the
  reference leaf's norm and the median leaf's; the worst leaf;
* ``update_gap``: the same of each parameter's change over the three
  steps, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (the rest move by round-off under Adam).
"""

from __future__ import annotations

import torch

from port_bench.reference import ops
from port_bench.reference.generator import generator


#: a generator row's error (patch units) past which ``pass<i>_over`` counts
#: it: a sound run's rows stay within it but for the kNN's near-tie swaps
ROW_TOL = 1e-4


def _count_diff(a, b) -> int:
    a, b = torch.as_tensor(a), torch.as_tensor(b).to(torch.as_tensor(a))
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a != b).sum())


@torch.no_grad()
def serve_request(P, cloud, cap, attention_bf16):
    """Numbers of one request: ``cloud`` (n, 3) on the device, ``cap`` the
    stages the program produced (``drivers/serve.py``'s record)."""
    cloud_n, centroid, furthest = ops.normalize(cloud[None])
    out = {"norm_off": _count_diff(cap["cloud_n"], cloud_n),
           "seed_off": ops.fps_rounds_off(cloud_n, cap["seeds"])}
    s, p = cap["patches"].shape[:2]
    raw = cap["patches"] * cap["p_furthest"] + cap["p_centroid"]
    idx = ops.nearest_exact(raw.reshape(1, s * p, 3), cloud_n).reshape(s, p)
    d = ops.sq_dist(ops.take(cloud_n, cap["seeds"]), cloud_n)[0]
    inside = torch.gather(d, 1, idx)
    outside = d.scatter(1, idx, float("inf"))
    out["patch_gap"] = float(torch.clamp_min(
        inside.amax(1) - outside.amin(1), 0.0).max())
    patches, p_c, p_f = ops.normalize(cloud_n[0][idx])
    rows = []
    x = patches
    for i, (_, prog_out) in enumerate(cap["passes"]):
        ref = torch.cat([generator(P, x[j:j + 8],
                                   attention_bf16=attention_bf16)[1]
                         for j in range(0, s, 8)])
        rows.append(torch.linalg.vector_norm(prog_out[:s] - ref, dim=-1
                                             ).flatten())
        x = prog_out[:s]
    cand = (cap["gen_out"] * p_f + p_c).reshape(1, -1, 3)
    merge_off = _count_diff(cap["merge_in"], cand)
    picks = ops.nearest_exact(cap["merged"], cap["merge_in"])
    merge_off += _count_diff(ops.take(cap["merge_in"], picks), cap["merged"])
    merge_off += ops.fps_rounds_off(cap["merge_in"], picks)
    out["merge_off"] = merge_off
    out["out_off"] = _count_diff(
        torch.as_tensor(cap["out"]).to(cloud.device),
        (cap["merged"] * furthest + centroid)[0])
    return out, rows


def serve_numbers(P, clouds, caps, attention_bf16):
    """The cell's numbers over the checked requests: sums of the exact
    counts, the largest patch gap, each pass's 99th percentile row error
    and its share of rows past ``ROW_TOL``."""
    total, rows = {}, []
    for cloud, cap in zip(clouds, caps):
        one, r = serve_request(P, cloud, cap, attention_bf16)
        for k, v in one.items():
            total[k] = max(total.get(k, 0), v) if k == "patch_gap" \
                else total.get(k, 0) + v
        rows.append(r)
    for i in range(len(rows[0])):
        err = torch.cat([r[i] for r in rows])
        total[f"pass{i + 1}_err"] = float(torch.quantile(err, 0.99))
        total[f"pass{i + 1}_over"] = float((err > ROW_TOL).double().mean())
        total[f"pass{i + 1}_err_median"] = float(torch.median(err))
        total[f"pass{i + 1}_err_max"] = float(err.max())
    return total


def reference_capture(P, cloud, ratio, attention_bf16):
    """The reference's own stages in the record's form: the reference put
    in the program's place (the precision control)."""
    from port_bench.reference.serving import upsample

    st = upsample(P, cloud, ratio, attention_bf16)
    ins = [st["patches"]] + st["passes"][:-1]
    return dict(cloud_n=st["cloud_n"], seeds=st["seeds"],
                patches=st["patches"], p_centroid=st["p_centroid"],
                p_furthest=st["p_furthest"],
                passes=list(zip(ins, st["passes"])),
                gen_out=st["passes"][-1], merge_in=st["candidates"],
                merged=st["merged"], out=st["out"])


# ----------------------------------------------------------------- training

def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def _worst_leaf(prog: dict, ref: dict, keep=None):
    """(gap, leaf) of the leaf whose norm differs most, relative to the
    larger of its reference norm and the median leaf's."""
    rn, pn = _norms(ref), _norms(prog)
    keys = [k for k in ref if keep is None or k in keep]
    med = float(torch.median(torch.tensor([rn[k] for k in ref])))
    return max((abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30), k)
               for k in keys)


#: metrics a step logs but does not train on, compared on their own
LOGGED = ("uniform",)


def train_numbers(prog, ref):
    """``prog`` and ``ref``: {'losses': [{key: float}] a step, 'grads':
    {net: {leaf: tensor}}, 'start': {net: {leaf}}, 'after': {net:
    {leaf}}}."""
    gaps = {f"{k}@{i + 1}": abs(p[k] - r[k]) / max(abs(r[k]), 1e-30)
            for i, (p, r) in enumerate(zip(prog["losses"], ref["losses"]))
            for k in r}
    out = {}
    for at, g in gaps.items():
        key = at.split("@")[0]
        name = "uniform_gap" if key in LOGGED else "loss_gap"
        if g >= out.get(name, -1.0):
            out[name], out[name + "_at"] = g, at
    grad_gap, update_gap, skipped = (0.0, ""), (0.0, ""), []
    for net, rg in ref["grads"].items():
        g, leaf = _worst_leaf(prog["grads"][net], rg)
        grad_gap = max(grad_gap, (g, f"{net}:{leaf}"))
        rn = _norms(rg)
        med = float(torch.median(torch.tensor(list(rn.values()))))
        keep = {k for k, v in rn.items() if v >= 1e-3 * med}
        skipped += [f"{net}:{k}" for k in rn if k not in keep]
        delta_p = {k: prog["after"][net][k] - prog["start"][net][k]
                   for k in rg}
        delta_r = {k: ref["after"][net][k] - ref["start"][net][k]
                   for k in rg}
        g, leaf = _worst_leaf(delta_p, delta_r, keep)
        update_gap = max(update_gap, (g, f"{net}:{leaf}"))
    return dict(out, grad_gap=grad_gap[0], grad_gap_at=grad_gap[1],
                update_gap=update_gap[0], update_gap_at=update_gap[1],
                leaves_skipped=" ".join(skipped))


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number named in ``limits``
    at most its limit (a missing or non-finite number fails)."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = (isinstance(value, (int, float)) and value == value
                and value <= limit)
        ok = ok and good
        rows.append((name, value, limit))
    return ok, rows
