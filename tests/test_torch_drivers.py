"""The port's drivers of the loop fixture at the stock vocabulary's size
(orb_slam_cuda_tpu_torch/tools/vocab_e2e.py) and of the long CLI sequence
(orb_slam_cuda_tpu_torch/tools/long_sequence.py) against the JAX
package's tools/vocab_e2e.py and tools/long_sequence.py.

- Text files: long_sequence's rgb.txt, groundtruth.txt and settings.yaml
  are byte-equal to the JAX tool's generate() for the same poses, and
  both packages read the settings into the same SystemConfig fields.
- Images: the port's PNGs differ from the JAX tool's cv2 renders of the
  same poses by at most 4 gray levels (measured: at most 2 on these
  frames, and at most 4 over all 520 frames of the sequence).
- Scoring: the tool's ATE of one trajectory file equals the JAX tool's
  inline scoring (tools/long_sequence.py, main) within 1e-6; an empty
  file has none.
- Rehearsals: a --device cpu run of each tool at a few frames prints its
  JSON line with every field; with no card and no --device both raise.
- Slow tier: vocab_e2e's synthetic_512 circuit through both packages on
  the port's frames, compared by outcome.
"""

import filecmp
import json
import os
import subprocess

import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu.engine import Sensor as JSensor
from orb_slam_cuda_tpu.io import config as jconfig
from orb_slam_cuda_tpu.utils import evaluation as jev
from orb_slam_cuda_tpu.utils import synthetic as jsyn
from orb_slam_cuda_tpu_torch.engine import Sensor
from orb_slam_cuda_tpu_torch.io import config as tconfig
from orb_slam_cuda_tpu_torch.io import png
from orb_slam_cuda_tpu_torch.tools import long_sequence as tls
from orb_slam_cuda_tpu_torch.tools import vocab_e2e as tve
from torch_drivers_divergence import jax_tool, run_vocab
from torch_parity import assert_configs_equal

torch.set_num_threads(2)
GEN_FRAMES = 3
MAX_GRAY_DIFF = 4
VOCAB_FIELDS = {"metric", "n_words", "frames", "tracked_ratio", "keyframes", "loops_closed", "ate_rmse", "wall_s",
                "relocalizations", "extent_m", "ate_pct_extent", "fast_launches", "fast_launches_equal_frames",
                "fps", "frame_ms_p50", "frame_ms_p99", "render_s", "render_device", "stage_ms", "device", "card"}
LONGSEQ_FIELDS = {"metric", "value", "unit", "frames", "tracked_pct", "loops_closed", "wall_s", "fps", "extent_m",
                  "ate_pct_extent", "n_scored", "keyframes", "relocalizations", "median_tracking_ms",
                  "p99_tracking_ms", "generate_s", "device", "card"}


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    """The JAX tool's first frames (cv2) and the port's on the JAX tool's
    poses: (jax dir, port dir, poses)."""
    root = tmp_path_factory.mktemp("longseq")
    jls = jax_tool("long_sequence")
    jls.N_FRAMES, jls.ROOT = GEN_FRAMES, str(root / "jax")
    seen = {}
    circuit = jsyn.circuit_trajectory

    def spy(*a, **k):
        seen["poses"] = circuit(*a, **k)
        return seen["poses"]

    jsyn.circuit_trajectory = spy
    try:
        jls.generate()
    finally:
        jsyn.circuit_trajectory = circuit
    tls.generate(str(root / "port"), GEN_FRAMES, device="cpu", poses=seen["poses"])
    return str(root / "jax"), str(root / "port"), seen["poses"]


@pytest.mark.parametrize("name", ["rgb.txt", "groundtruth.txt", "settings.yaml"])
def test_long_sequence_text_files_byte_equal(sequences, name):
    jdir, tdir, _ = sequences
    assert filecmp.cmp(os.path.join(jdir, name), os.path.join(tdir, name), shallow=False)


def test_long_sequence_settings_read_equal(sequences):
    path = os.path.join(sequences[1], "settings.yaml")
    jcfg = jconfig.load_settings(path, sensor=JSensor.MONOCULAR)
    tcfg = tconfig.load_settings(path, sensor=Sensor.MONOCULAR)
    assert_configs_equal(jcfg, tcfg)
    assert (tcfg.n_features, tcfg.max_keyframes, tcfg.max_points, tcfg.pipeline_lag) == (800, 256, 32768, 0)
    assert (tcfg.camera.width, tcfg.camera.height, tcfg.camera.fx) == (320, 240, 260.0)


def test_long_sequence_images_within_gray_levels(sequences):
    import cv2

    jdir, tdir, _ = sequences
    for i in range(GEN_FRAMES):
        j = cv2.imread(os.path.join(jdir, "rgb", f"{i:06d}.png"), cv2.IMREAD_GRAYSCALE)
        t = png.read_gray(os.path.join(tdir, "rgb", f"{i:06d}.png"))
        assert j.shape == t.shape == (240, 320) and t.dtype == np.uint8
        diff = np.abs(j.astype(np.int16) - t.astype(np.int16))
        assert diff.max() <= MAX_GRAY_DIFF, (i, int(diff.max()))
        assert (diff > 0).mean() < 0.06, i  # measured: 3.4% of pixels differ, 4.1% at most


def test_long_sequence_scoring_matches_reference(sequences, tmp_path):
    """A trajectory with noise, a scale, missing frames and a stamp with
    no ground truth, scored by the tool and by the JAX tool's code."""
    rng = np.random.default_rng(5)
    root = str(tmp_path)
    poses = tls.fixture(60, laps=tls.LAPS)[2]
    tls.write_text_files(root, poses)
    gt_rows = np.loadtxt(f"{root}/groundtruth.txt")
    keep = np.flatnonzero(rng.random(60) > 0.2)
    est = gt_rows[keep].copy()
    est[:, 1:4] = 0.7 * est[:, 1:4] + rng.normal(0, 0.05, (len(keep), 3))
    est = np.vstack([est, [99.0, 1, 2, 3, 0, 0, 0, 1]])
    traj = f"{root}/traj.txt"
    np.savetxt(traj, est, fmt="%.6f")
    ate, extent, n, extras = tls.score(root, traj)
    # tools/long_sequence.py, main: the JAX tool's scoring.
    gt_map = {round(t, 6): p for t, *p in gt_rows[:, :4]}
    je, jg = [], []
    for t, x, y, z, *_ in np.loadtxt(traj):
        if round(t, 6) in gt_map:
            je.append([x, y, z])
            jg.append(gt_map[round(t, 6)])
    want = jev.ate_rmse(np.asarray(je), np.asarray(jg))
    assert n == len(keep) and abs(ate - want) <= 1e-6 and ate > 0.01
    assert extent == pytest.approx(np.linalg.norm(np.ptp(gt_rows[:, 1:4], axis=0)))
    assert extras["gaps"] and "scale_seg_ratio" in extras
    open(traj, "w").close()
    assert tls.score(root, traj) == (None, None, 0, {})


def test_long_sequence_parses_cli_lines():
    err = ("frame 0 state=NOT_INITIALIZED kfs=0 104ms\n"
           "tracked 497/520 frames (95.6%); median tracking time 83.7ms, mean 232.1ms; 111 keyframes\n"
           "p99 tracking time 1281.5ms; 3 relocalizations\nloops closed: 2\n")
    assert tls.parse_cli(err) == dict(median_tracking_ms=83.7, keyframes=111, p99_tracking_ms=1281.5,
                                      relocalizations=3)


def test_long_sequence_rehearsal_on_cpu(tmp_path, monkeypatch, capsys):
    """30 frames: the map initializes, so the line carries an ATE. The
    CLI's process gets 2 threads, as this process has."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    assert tls.main(["--device", "cpu", "--frames", "30", "--root", str(tmp_path / "seq")]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert LONGSEQ_FIELDS <= set(rec) <= LONGSEQ_FIELDS | {"ate_windowed60_m", "scale_seg_ratio", "gaps"}
    assert rec["metric"] == "long_sequence_ate_rmse" and rec["frames"] == 30 and rec["device"] == "cpu"
    assert rec["card"] is None and rec["tracked_pct"] is not None and rec["keyframes"] >= 2
    assert rec["n_scored"] >= 3 and rec["value"] is not None and rec["relocalizations"] == 0
    assert len(os.listdir(tmp_path / "seq" / "rgb")) == 30


def test_long_sequence_cli_failure_exits_nonzero(tmp_path, monkeypatch, capsys):
    def failed(cmd, **kw):
        return subprocess.CompletedProcess(cmd, 3, "", "Traceback: boom\n")

    tls.write_text_files(str(tmp_path), tls.fixture(2, laps=tls.LAPS)[2])
    monkeypatch.setattr(subprocess, "run", failed)
    assert tls.main(["--device", "cpu", "--frames", "2", "--root", str(tmp_path)]) == 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "metric": "long_sequence", "error": "orb_slam_cuda_tpu_torch.run failed rc=3"}


def test_vocab_e2e_rehearsal_on_cpu(tmp_path, monkeypatch, capsys):
    """Both runs at a few frames on the depth-4 stock-scale file, which the
    tool generates under <repo>/build (here a temporary one)."""
    monkeypatch.setattr(tve, "REPO", str(tmp_path))
    assert tve.main(["--device", "cpu", "--frames", "6", "--vocab-depth", "4"]) == 0
    assert os.path.exists(tmp_path / "build" / "orbvoc_k10_L4.txt")
    stock, control = (json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()[-2:])
    assert set(stock) == VOCAB_FIELDS | {"vocab_load_s"} and set(control) == VOCAB_FIELDS
    assert stock["metric"] == "vocab_e2e_stock_k10_L4" and stock["n_words"] == 9820
    assert control["metric"] == "vocab_e2e_synthetic_512" and control["n_words"] == 512
    for rec in (stock, control):
        assert rec["frames"] == 6 and rec["device"] == "cpu" and rec["card"] is None
        assert rec["fast_launches"] == 0 and rec["fast_launches_equal_frames"] is None
        assert rec["render_device"] == "cpu (the host)" and rec["stage_ms"]["build_frame"] > 0


@pytest.mark.parametrize("tool", [tve, tls], ids=["vocab_e2e", "long_sequence"])
def test_tools_default_to_card_and_raise_without_one(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(["--frames", "2"])


@pytest.mark.slow
def test_vocab_e2e_synthetic_512_both_packages_on_cpu():
    """The vocab_e2e control (the synthetic 512-word tree, 360 frames)
    through the JAX System and the port's on the port's frames. By
    outcome: the port tracks within 0.05 of JAX's ratio, closes a loop
    where JAX closes one, and inserts keyframes within 25% of JAX's."""
    j = run_vocab("jax", "torch", "synthetic", trace=False)
    t = run_vocab("port", "torch", "synthetic", trace=False)
    print("jax", j, "\nport", t)
    assert t["tracked"] >= j["tracked"] - 0.05, (j, t)
    assert t["loops"] >= min(j["loops"], 1), (j, t)
    assert abs(t["keyframes"] - j["keyframes"]) <= 0.25 * j["keyframes"], (j, t)
