"""The byte and operation counts against shapes worked out by hand."""
from portbench.counts import ingest, peaks


def test_grid_kernel_at_the_cell_shape():
    d, m = 100_000, 500
    # in: ts, v; per device eleven f64, n_changes, has_prev
    ins = m * 8 + d * m * 8 + d * (11 * 8 + 8 + 1)
    # out: twelve 8-byte per device; cum_e, cum_ec, run_dur, run_rec
    outs = d * 12 * 8 + d * m * (8 + 8 + 8 + 1)
    assert ingest.grid_kernel_bytes(d, m) == ins + outs == 1_669_304_000
    assert ingest.grid_kernel_ops(d, m) == 35 * d * m
    # bytes bound the kernel: 0.498 ms at 3.35 TB/s
    assert abs(peaks.bound_s(ins + outs, 35 * d * m) - 4.981e-4) < 1e-6


def test_flat_kernel():
    k, u = 50_500_000, 100_000
    ins = k * 16 + u * 16 + u * 97
    outs = u * 14 * 8 + k * 33
    assert ingest.flat_kernel_bytes(k, u) == ins + outs
    assert ingest.flat_kernel_ops(k) == 35 * k


def test_slab_minimum():
    d, m, r = 100_000, 500, 8
    # DeviceState: fourteen 8-byte fields and has; the ring: four f64 a
    # slot and n_written
    state = d * (14 * 8 + 1 + r * 4 * 8 + 8)
    assert ingest.slab_min_bytes(d * m, d, 8, r, shared_times=m) == (
        d * m * 8 + m * 8 + 2 * state)
    assert ingest.slab_min_bytes(10, 1, 24, 0) == 240 + 2 * (113 + 8)
