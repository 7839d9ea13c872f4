"""Where the port and the JAX package part on the CPU (ROADMAP queue 3, B),
through tests/torch_divergence.py on the first 120 frames of
config_mono_tum (slow tier, about half an hour on one core). What it
pins: frame 0's extraction agrees (keypoints exact, every descriptor row
equal); at the first frame where the keyframe insertions differ, the
port's tracking step on the JAX System's own inputs gives the same
keyframe-policy inputs (inliers, the reference keyframe's tracked points)
and a pose within 1e-4; and the last local BA before the first frame
whose inlier count differs agrees within float32 rounding (points within
1e-3, poses within 1e-4) but not bit for bit. So the packages part by a
rounding difference that the pose-only LM's chi2 test and the keyframe
policy's thresholds amplify, not by a fault of either."""

import pytest

import torch_divergence


@pytest.mark.slow
def test_packages_part_by_rounding_not_by_a_fault(tmp_path):
    out = torch_divergence.search(str(tmp_path))
    print(out)
    ext = out["extraction_frame0"]
    assert ext["keypoints_equal"] and ext["identical_descriptor_rows"] == 1.0
    first = out["jax vs port"]["first_keyframe_difference"]
    if first is None:
        return
    same = out["same_inputs"]
    step = same["tracking_step"]
    assert step["scalars_jax"][1] == step["scalars_port"][1], "inliers on the same inputs"
    assert step["scalars_jax"][3] == step["scalars_port"][3], "reference keyframe's tracked points"
    assert step["pose_max_diff"] < 1e-4
    ba = same["local_ba"]
    assert ba["xyz_max_diff"] < 1e-3 and ba["cam_pose_max_diff"] < 1e-4
