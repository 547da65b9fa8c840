"""Each cell's control, kept at a size a test run holds: the reference
one precision step below the configuration's (TF32 operands for the
float32 arena, float8 e4m3 for the bf16 build) put in the program's
place must come out not correct, and the program correct, against the
limits in the mix files."""
import pytest

from cfbench.control import readings


@pytest.mark.parametrize("cell", ["douban-onboard", "douban-onboard-fresh",
                                  "ml20m-onboard", "douban-read",
                                  "douban-build"])
def test_control_fails_program_passes(cell, tiny):
    r = readings(cell, [101, 102, 103], 1.0, "cpu", tiny)
    limits = r["limits"]
    assert all(r["lower"][k] <= limits[k] for k in limits), r
    failed = [k for k in limits if r["upper"][k] > limits[k]]
    assert failed, f"the {r['control']} control passed every number: {r}"
