"""The output check's control, at a size a test run holds: the plain
reference one precision step lower (float32) in the program's place must
fail the cell's limits, while the program itself passes them."""
import pytest

from portbench import control, harness


@pytest.mark.parametrize("workload,n", [("fleet100k-1khz.aligned", 40),
                                        ("fleet100k-1khz.shuffled", 40),
                                        ("audit1m-mix.batch", 2)])
def test_control_is_not_correct(small_cell, workload, n):
    cell = small_cell(workload)
    vals = control.control(cell, 2**31 + 21, n_slabs=n, n_audits=n)
    limits = harness.limits(cell)
    assert set(vals) == set(limits)
    assert not harness.passed({k: (v, float(limits[k]))
                               for k, v in vals.items()})
