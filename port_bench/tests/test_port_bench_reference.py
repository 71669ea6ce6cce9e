"""The reference's counted model FLOPs against a count from the layer
shapes alone (2·rows·in·out a dense layer, 4·n²·c for attention, the
pooling's 2·n·k·k·c), at one patch, for both passes and one CD training
step; and the reference against the program's plain path at a tiny size
(``test_port_bench_faults.test_sound_run_is_correct`` runs the whole
check so; here one generator pass is held to it directly)."""

import json

import torch

from port_bench.lib import data
from port_bench.lib.cell import ROOT
from port_bench.lib.counting import pass_flops, step_flops

CFG = json.loads((ROOT / "port_bench/configs/dispu.json").read_text())


def _weights():
    return data.weights(CFG["weights"]["generator"], 5,
                        torch.device("cpu"))


def dense(rows, i, o):
    return 2 * rows * i * o


def pass_count(n, k=16):
    """(f32 FLOPs, bf16 FLOPs) of one generator pass over an n-point
    patch at the published widths."""
    f = dense(n, 3, 24)
    f += dense(n * k, 48, 24) + dense(n * k, 48, 24) + dense(n * k, 72, 24)
    for width in (120, 240, 360):
        f += dense(n, width, 48)
        f += dense(n * k, 96, 24) + dense(n * k, 72, 24) \
            + dense(n * k, 96, 24)
    m = 4 * n                                   # the coarse points
    f += dense(m, 482, 256) + dense(m, 256, 128)
    f += dense(m, 128, 256) + dense(m, 256, 64) + dense(m, 64, 3)
    f += dense(m, 128, 128) + dense(m, 128, 64) + dense(m, 64, 256)
    f += dense(m, 134, 256) + dense(m * k, 134, 128) \
        + dense(m * k, 128, 128) + dense(m * k, 3, 16)
    f += 2 * m * k * k * 128                    # the pooling
    f += dense(m, 2048, 256) + dense(m, 256, 256)
    f += dense(m, 256, 256) + dense(m, 256, 64) + dense(m, 64, 3)
    attention = 4 * m * m * 64
    return f, attention


def test_pass_flops_match_the_layer_count():
    P = _weights()
    for n in (256, 1024):
        got = pass_flops(P, n)
        f32, bf16 = pass_count(n)
        assert got[torch.float32] == f32
        assert got[torch.bfloat16] == bf16


def test_train_step_flops_match_the_layer_count():
    """Forward, then every product's two gradients (its input's and its
    weight's), less the input gradient of the first layer, whose input is
    data; attention's backward runs in f32."""
    got = step_flops({"G": _weights()}, 1, False, 1024, 256)
    f32, bf16 = pass_count(256)
    assert got[torch.bfloat16] == bf16
    assert got[torch.float32] == 3 * f32 + 2 * bf16 - dense(256, 3, 24)


def test_reference_pass_matches_the_plain_path():
    from dispu_tpu_torch.models.generator import DisPUGenerator
    from port_bench.reference.generator import generator

    P = _weights()
    model = DisPUGenerator(impl="torch")
    model.load_state_dict(P)
    x = torch.rand((2, 256, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x)[1]
        got = generator(P, x)[1]
    assert torch.allclose(got, want, rtol=0, atol=1e-6)
