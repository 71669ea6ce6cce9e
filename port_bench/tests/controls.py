"""The readings a cell's limits are set between, made without the
program: the precision control (the reference put in the program's
place at the nearest lower precision, TF32 products for an f32
configuration) and, for a training cell, the planted fault of half a
batch left out (the reference's step on the first half of each batch).
``test_port_bench_control.py`` runs them on the card at the cells' own
sizes; the benchmark's runs never do.

A cell's driver is built here without its program: :meth:`inputs` makes
the weights and inputs from the seed, as a run's set-up does."""

from __future__ import annotations

import torch

from port_bench.lib.cell import Cell, driver, module
from port_bench.lib.check import (reference_capture, serve_numbers,
                                  train_numbers)


def inputs_only(workload, seed, device):
    """The cell's driver with its inputs and weights and no program."""
    cell = Cell(workload)
    Driver = driver(cell.traffic["driver"])
    drv = Driver.__new__(Driver)
    drv.inputs(cell, seed, device)
    return drv


def serve_control(workload, seed, device):
    """The cell's numbers with the TF32 reference's stages judged as the
    program's would be."""
    drv = inputs_only(workload, seed, device)
    bf16 = device.type == "cuda"
    clouds = [drv.pool[c] for c in sorted(drv.checked)]
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        caps = [reference_capture(drv.weights, c, drv.ratio, bf16)
                for c in clouds]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return serve_numbers(drv.weights, clouds, caps, bf16)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def train_control(workload, seed, device, fault="tf32"):
    """The cell's numbers with the reference's first steps, at TF32
    (``fault='tf32'``) or on half of each batch (``'half_batch'``),
    judged as the program's would be."""
    drv = inputs_only(workload, seed, device)
    reference_record = module("drivers",
                              drv.cell.traffic["driver"]).reference_record
    drv.first_batches = [drv.next_indices()
                         for _ in range(drv.cell.traffic["warm_steps"])]
    bf16 = device.type == "cuda"
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        if fault == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            prog = reference_record(drv, bf16)
        else:
            prog = reference_record(drv, bf16,
                                    batch_rows=slice(0, drv.batch // 2))
        torch.backends.cuda.matmul.allow_tf32 = False
        ref = reference_record(drv, bf16)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return train_numbers(prog, ref)
