"""``BENCHMARK.json`` against the benchmark's contract, and every name in
it found in its file: configurations, traffic mixes, limits, metric
readers."""

import json
import math
import re

import pytest

from port_bench.lib import cell as C

MAN = C.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
#: what ``lib/bench.run`` calls on every cell's driver, whatever its mix
DRIVER_CALLS = ("inputs", "build", "warm", "window", "metrics",
                "log_window", "run_n", "flops_per_unit", "free_program",
                "check")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|experts_per_tok)")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((C.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    """2 + 14 runs a cell, each run_seconds + 60, each cell 180 s more,
    1200 s spare, with the full 24 cells."""
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind,entries", [
    ("config", MAN["configs"]), ("workload", MAN["workloads"]),
    ("end_to_end", MAN["end_to_end"]), ("per_layer", MAN["per_layer"])])
def test_entries(kind, entries):
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"])
        if kind in ("end_to_end", "per_layer"):
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
            assert e["source"] in SOURCES
        if "why" in e:
            assert _line(e["why"])


def test_counts_and_cells():
    assert 1 <= len(MAN["configs"]) <= 24
    assert 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16
    assert 1 <= len(MAN["per_layer"]) <= 128
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert all(w["chips"] in (1, 4) for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_every_config_has_a_cell_and_a_file():
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
        assert (C.ROOT / c["file"]).is_file()
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])


def test_setup_and_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def _reported(metric, workload):
    return workload in metric.get("workloads", [workload])


def test_every_cell_reports_enough():
    for w in MAN["workloads"]:
        n = w["name"]
        e2e = [m["name"] for m in MAN["end_to_end"] if _reported(m, n)]
        assert "setup_s" in e2e and len(e2e) >= 2, n
        assert any(_reported(m, n) for m in MAN["per_layer"]), n


def test_moves_are_reported_where_the_metric_is():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    names = {w["name"] for w in MAN["workloads"]}
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for w in m.get("workloads", names):
            assert w in names
            assert _reported(e2e[m["moves"]], w), (m["name"], w)
        assert _line(m["layer"])
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in MAN["end_to_end"]:
        assert set(m.get("workloads", names)) <= names


def test_rooflines_and_mfu_are_percent():
    for m in MAN["per_layer"]:
        if m["name"].endswith("_roofline") or "roofline" in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%", m["name"]


@pytest.mark.parametrize("w", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(w):
    cell = C.Cell(w)
    Driver = C.driver(cell.traffic["driver"])
    for method in DRIVER_CALLS:
        assert callable(getattr(Driver, method)), (w, method)
    assert callable(C.shape(cell.traffic["shape"]))
    assert cell.limits and all(isinstance(v, (int, float)) and v >= 0
                               for v in cell.limits.values())
    for m in cell.per_layer:
        assert callable(C.metric_reader(m["name"]))
    cfg = cell.config
    assert cfg["compute_dtype"] == "float32"
    assert "weights" in cfg and "generator" in cfg["weights"]
    assert cfg["use_gan"] == ("critic" in cfg["weights"])


def test_missing_files_are_named():
    with pytest.raises(FileNotFoundError, match="traffic/nope.json"):
        C.traffic("nope")
    with pytest.raises(FileNotFoundError, match="metrics/nope.py"):
        C.metric_reader("nope")
    with pytest.raises(FileNotFoundError, match="drivers/nope.py"):
        C.driver("nope")
    with pytest.raises(FileNotFoundError, match="shapes/nope.py"):
        C.shape("nope")
    with pytest.raises(KeyError, match="no workload"):
        C.Cell("nope")


def test_config_matches_the_ports_defaults():
    """The configuration files hold every setting as the program's
    dataclasses default it (the published configuration, no cut)."""
    import dataclasses

    from dispu_tpu_torch import config as P

    for c in MAN["configs"]:
        cfg = json.loads((C.ROOT / c["file"]).read_text())
        for key, cls in (("generator", P.GeneratorConfig),
                         ("inference", P.InferenceConfig),
                         ("loss", P.LossConfig), ("train", P.TrainConfig),
                         ("data", P.DataConfig)):
            want = {k: (list(v) if isinstance(v, tuple) else v)
                    for k, v in dataclasses.asdict(cls()).items()}
            assert cfg[key] == want, (c["name"], key)


def test_weights_cover_the_models():
    from dispu_tpu_torch.models.discriminator import PatchDiscriminator
    from dispu_tpu_torch.models.generator import DisPUGenerator

    for c in MAN["configs"]:
        cfg = json.loads((C.ROOT / c["file"]).read_text())
        shapes = cfg["weights"]["generator"]
        sd = DisPUGenerator().state_dict()
        assert {k: list(v.shape) for k, v in sd.items()} == shapes
        total = sum(math.prod(s) for s in shapes.values())
        assert 1.0e6 < total < 1.1e6
        if "critic" in cfg["weights"]:
            sd = PatchDiscriminator().state_dict()
            assert {k: list(v.shape) for k, v in sd.items()} == \
                cfg["weights"]["critic"]
