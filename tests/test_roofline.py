"""Roofline cost models and the peaks table (utils/roofline): pure math,
no device."""

import numpy as np
import pytest

from visual_odometry_tpu.utils import roofline


def test_models_scale_linearly():
    m1 = roofline.matcher_model(1024, 1 << 16)
    m2 = roofline.matcher_model(1024, 1 << 17)
    assert m2.matmul_flops == 2 * m1.matmul_flops
    p1 = roofline.picp_model(512, 50)
    p2 = roofline.picp_model(1024, 50)
    assert p2.vector_ops == 2 * p1.vector_ops
    f1 = roofline.frame_model(128, 1024, 2, 10)
    f2 = roofline.frame_model(256, 1024, 2, 10)
    assert f2.vector_ops == 2 * f1.vector_ops
    assert f2.hbm_bytes == 2 * f1.hbm_bytes


def test_speed_of_light_and_report_fields():
    chip = roofline.peaks("NVIDIA H100 80GB HBM3")
    m = roofline.matcher_model(1024, 131072)
    sol = m.speed_of_light_s(chip)
    assert sol > 0
    rep = m.report(sol * 2, chip)  # pretend we run at half of light
    assert abs(rep["matcher_roofline_fraction"] - 0.5) < 1e-6
    for k in ("matcher_time_us", "matcher_gbps", "matcher_matmul_gflops",
              "matcher_vector_gops"):
        assert k in rep and np.isfinite(rep[k])


def test_gn_model_is_vpu_bound():
    chip = roofline.peaks("NVIDIA H100 80GB HBM3")
    p = roofline.picp_model(1024, 100)
    assert p.vector_ops / chip.vector_ops > p.hbm_bytes / chip.hbm_bw
    assert p.matmul_flops == 0.0


def test_unknown_device_kind_is_an_error():
    """No default peaks: a device missing from the table cannot get a
    roofline share."""
    with pytest.raises(KeyError, match="no published peaks"):
        roofline.peaks("cpu")
    for spec in roofline.PEAKS.values():
        assert spec.source and spec.hbm_bw > 0 and spec.matmul_flops > 0
