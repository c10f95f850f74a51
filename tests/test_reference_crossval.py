"""Cross-validation against the reference C++ `evaluation` binary.

Builds the reference evaluator from /root/reference (read-only) with the
Eigen headers bundled in tensorflow, runs it on OUR pipeline's output
files, and checks it reports the same metrics as our evaluator — proving
the output-file contract end to end. Skips when the toolchain/reference
tree is unavailable.
"""

import os
import re
import subprocess

import numpy as np
import pytest

from visual_odometry_tpu import apps

EIGEN = "/opt/venv/lib/python3.12/site-packages/tensorflow/include"
REF = "/root/reference"
BIN = "/tmp/vo_test_refeval"


@pytest.fixture(scope="module")
def ref_eval_binary():
    if not (os.path.isdir(REF) and os.path.isdir(EIGEN)):
        pytest.skip("reference tree or Eigen headers unavailable")
    if not os.path.exists(BIN):
        srcs = [
            f"{REF}/src/apps/evaluate.cpp",
            f"{REF}/src/utils.cpp",
            f"{REF}/src/files_utils.cpp",
            f"{REF}/src/evaluation_utils.cpp",
            f"{REF}/src/camera.cpp",
        ]
        r = subprocess.run(
            ["g++", "-O3", "-DNDEBUG", "-std=c++17", f"-I{EIGEN}", f"-I{REF}/include",
             "-o", BIN] + srcs,
            capture_output=True,
            timeout=180,
        )
        if r.returncode != 0:
            pytest.skip(f"reference build failed: {r.stderr[:200]}")
    return BIN


def test_reference_evaluator_agrees_on_our_outputs(
    ref_eval_binary, reference_data_dir, tmp_path
):
    out = str(tmp_path)
    apps.run_vo_complete(reference_data_dir, out, verbose=False)
    ours = apps.run_evaluation(reference_data_dir, out, verbose=False)

    r = subprocess.run(
        [ref_eval_binary, reference_data_dir],
        cwd=out,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert r.returncode == 0, r.stderr[:300]
    nums = {
        m.group(1): float(m.group(2))
        for m in re.finditer(r"(ratio used for map correction|RMSE position|RMSE map): ([\d.eE+-]+)", r.stdout)
    }
    assert abs(nums["ratio used for map correction"] - ours.scale) < 1e-4
    assert abs(nums["RMSE position"] - ours.rmse_position) < 1e-4
    assert abs(nums["RMSE map"] - ours.rmse_map) < 1e-4
