"""The frozen yardsticks against the program's formulas today, so a
change to either shows."""
import torch

from cfbench import roofline


def test_build_count_equals_the_similarity_kernels_formula():
    from repro_torch.kernels.similarity.kernel import cost
    n, m = 32768, 58541
    c = cost(n, n, m, torch.bfloat16)
    assert roofline.build_flops(n, m) == c.flops == 2.0 * n * n * m
    assert not c.fp32
    assert abs(roofline.build_bound_s(n, m) - 0.12711409528571083) < 1e-12


def test_peaks_equal_the_programs_roofline_today():
    from repro_torch.launch import roofline as prog
    names = {n: getattr(prog, n) for n in dir(prog) if n.isupper()}
    values = set(v for v in names.values() if isinstance(v, float))
    for peak in (roofline.BF16_FLOPS_PER_S, roofline.FP32_FLOPS_PER_S,
                 roofline.HBM_BYTES_PER_S):
        assert peak in values, (peak, names)


def test_rotation_least_bytes():
    # old lists read once, new written once: 8 bytes an entry
    assert roofline.rotation_bytes(32832, 32896) == 8.0 * (
        32832 ** 2 + 32896 ** 2)
    t = roofline.rotation_bound_s(32832, 32896)
    assert abs(t - 8.0 * (32832 ** 2 + 32896 ** 2) / 3.35e12) < 1e-15
