"""PyTorch port, offline lip extraction (``data/lip_extract.py``) and
``data/avi.py:open_video``, held against the JAX package on the CPU.

MediaPipe is not installed here: the extraction runs through an injected
detector, precomputed boxes (``boxes_for_range``) and the heuristic
localizer, as ``tests/test_lip_extract.py`` runs the JAX one; the mediapipe
path is only gated.  Tolerances: none.  Boxes, skip lists and saved clips
are equal (the clips byte for byte, after numpy's ``astype(np.uint8)``
truncation), and so are the frames of both readers.
"""

import json
import os

import numpy as np
import pytest

from multimodal_av_model_tpu.data import lip_extract as jle
from multimodal_av_model_tpu.data.avi import open_video as j_open_video
from multimodal_av_model_tpu_torch.data import lip_extract as ple
from multimodal_av_model_tpu_torch.data.avi import avi_frame_reader, open_video, write_avi
from test_lip_extract import iou, synthetic_face_frames


def test_landmark_index_set():
    assert ple.LIP_LANDMARK_INDICES == jle.LIP_LANDMARK_INDICES
    assert len(set(ple.LIP_LANDMARK_INDICES)) == 40


def test_lip_box_margin_clamp_and_degenerate():
    for xs, ys, W, H, margin in (([100.0, 150.0], [200.0, 230.0], 1920, 1080, 10),
                                 ([2.0], [3.0], 640, 480, 10), ([5.0], [5.0], 640, 480, 0),
                                 ([630.5, 639.9], [470.2, 479.0], 640, 480, 10)):
        args = (np.array(xs), np.array(ys), W, H, margin)
        assert ple.lip_box_from_landmarks(*args) == jle.lip_box_from_landmarks(*args)
    assert ple.lip_box_from_landmarks(np.array([100.0, 150.0]), np.array([200.0, 230.0]),
                                      1920, 1080, 10) == (90, 190, 160, 240)
    assert ple.lip_box_from_landmarks(np.array([5.0]), np.array([5.0]), 640, 480, 0) is None


def test_crop_clip_from_boxes_equals_jax():
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 255, size=(3, 64, 80, 3)).astype(np.float32)
    boxes = np.array([[10, 10, 42, 50], [0, 3, 80, 64], [5, 7, 21, 15]], np.int32)
    got = ple.crop_clip_from_boxes(frames, boxes, out_size=16)
    assert got.shape == (3, 16, 16, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jle.crop_clip_from_boxes(frames, boxes, out_size=16))
    same = ple.crop_clip_from_boxes(frames[:, :16, :16], np.array([[0, 0, 16, 16]] * 3), 16)
    np.testing.assert_allclose(same, frames[:, :16, :16], rtol=1e-5)


def test_mediapipe_gate_equals_jax():
    assert ple.have_mediapipe() == jle.have_mediapipe()


def test_box_blur_and_score_map_equal_jax():
    frames, _ = synthetic_face_frames(T=2)
    for k in (1, 3, 5):
        img = frames[0, ..., 0].astype(np.float32)
        np.testing.assert_array_equal(ple._box_blur(img, k), jle._box_blur(img, k))
    np.testing.assert_array_equal(ple.lip_score_map(frames[1]), jle.lip_score_map(frames[1]))


@pytest.fixture(scope="module")
def face_avi(tmp_path_factory):
    frames, gt = synthetic_face_frames(T=8)
    path = str(tmp_path_factory.mktemp("face") / "face.avi")
    write_avi(path, frames)
    return path, frames, gt


def test_heuristic_boxes_equal_jax_on_a_synthetic_avi(face_avi):
    path, frames, gt = face_avi
    decoded = open_video(path)(0, len(frames))
    np.testing.assert_array_equal(decoded, frames)
    margin = 10
    got = ple.detect_lip_boxes_heuristic(decoded, margin=margin)
    np.testing.assert_array_equal(got, jle.detect_lip_boxes_heuristic(decoded, margin=margin))
    assert got.dtype == np.int32 and got.shape == gt.shape
    H, W = frames.shape[1:3]
    for t in range(len(gt)):                        # the lips inside a lip-sized box
        assert got[t, 0] <= gt[t, 0] and got[t, 1] <= gt[t, 1]
        assert got[t, 2] >= gt[t, 2] and got[t, 3] >= gt[t, 3]
        gx = (max(0, gt[t, 0] - margin), max(0, gt[t, 1] - margin),
              min(W, gt[t, 2] + margin), min(H, gt[t, 3] + margin))
        assert iou(got[t], gx) >= 0.5
    np.testing.assert_array_equal(ple.detect_lip_boxes_auto(decoded), got)
    grey = np.full((3, 40, 40, 3), 128, np.uint8)
    assert ple.detect_lip_boxes_heuristic(grey) is None
    assert jle.detect_lip_boxes_heuristic(grey) is None


def _sentences_json(tmp_path, spans, as_list=True):
    meta = {"Sentence_info": [{"ID": i + 1, "sentence_text": "가", "start_time": s,
                               "end_time": e} for i, (s, e) in enumerate(spans)]}
    path = str(tmp_path / "v.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump([meta] if as_list else meta, f)
    return path


def _run_both(tmp_path, *args, **kwargs):
    got = ple.extract_clips(args[0], args[1], str(tmp_path / "port"), *args[2:], **kwargs)
    want = jle.extract_clips(args[0], args[1], str(tmp_path / "jax"), *args[2:], **kwargs)
    assert [os.path.basename(p) for p in got.saved] == [os.path.basename(p) for p in want.saved]
    assert got.skipped == want.skipped
    for g, w in zip(got.saved, want.saved):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read(), g
    return got


@pytest.mark.parametrize("scale", [255.0, 1.0])
def test_extract_clips_with_injected_detector_byte_equal(tmp_path, scale):
    """Frames in 0..255 save as uint8 (numpy's truncation), in 0..1 as f32."""
    rng = np.random.default_rng(1)
    frames_all = (rng.uniform(0, 1, size=(9, 48, 56, 3)) * scale).astype(np.float32)
    json_path = _sentences_json(tmp_path, [(0.0, 0.1), (0.1, 0.2), (0.2, 0.3)])

    def frames_for_range(start, end):
        return None if start >= 6 else frames_all[start:end]

    def detector():
        calls = []

        def boxes_for_frames(frames):
            calls.append(len(frames))
            if len(calls) == 2:
                return None
            return np.array([[4, 5, 37, 40]] * len(frames), np.int32)
        return boxes_for_frames

    got = ple.extract_clips(frames_for_range, json_path, str(tmp_path / "port"), "vid", fps=30,
                            out_size=32, boxes_for_frames=detector())
    want = jle.extract_clips(frames_for_range, json_path, str(tmp_path / "jax"), "vid", fps=30,
                             out_size=32, boxes_for_frames=detector())
    assert got.skipped == want.skipped == [(2, "face_not_detected"), (3, "frame_read_failed")]
    assert [os.path.basename(p) for p in got.saved] == ["vid_sentence_1.npy"]
    with open(got.saved[0], "rb") as fg, open(want.saved[0], "rb") as fw:
        assert fg.read() == fw.read()
    clip = np.load(got.saved[0])
    assert clip.shape == (3, 32, 32, 3)
    assert clip.dtype == (np.uint8 if scale > 1.5 else np.float32)


def test_extract_clips_with_precomputed_boxes_byte_equal(tmp_path, face_avi):
    path, frames, _ = face_avi
    boxes_all = jle.detect_lip_boxes_heuristic(frames)

    def boxes_for_range(start, end):
        return None if start >= 6 else boxes_all[start:end]

    json_path = _sentences_json(tmp_path, [(0.0, 0.1), (0.1, 0.2), (0.2, 0.25), (0.3, 0.5)],
                                as_list=False)
    got = _run_both(tmp_path, open_video(path), json_path, "face", out_size=40,
                    boxes_for_range=boxes_for_range)
    assert got.skipped == [(3, "face_not_detected"), (4, "frame_read_failed")]
    assert [np.load(p).shape for p in got.saved] == [(3, 40, 40, 3), (3, 40, 40, 3)]


def test_extract_clips_default_detector_byte_equal(tmp_path, face_avi):
    """Without MediaPipe the default detector is the heuristic localizer."""
    path, frames, _ = face_avi
    json_path = _sentences_json(tmp_path, [(0.0, 4 / 30.0), (4 / 30.0, 8 / 30.0)])
    got = _run_both(tmp_path, avi_frame_reader(path), json_path, "clip", out_size=64)
    if not ple.have_mediapipe():
        assert got.skipped == [] and len(got.saved) == 2
        assert np.load(got.saved[0]).shape == (4, 64, 64, 3)


def test_open_video_dispatch(tmp_path, face_avi):
    path, frames, _ = face_avi
    upper = str(tmp_path / "FACE.AVI")
    with open(path, "rb") as src, open(upper, "wb") as dst:
        dst.write(src.read())
    for p in (path, upper):
        got, want = open_video(p), j_open_video(p)
        np.testing.assert_array_equal(got(2, 7), want(2, 7))
        np.testing.assert_array_equal(got(2, 7), frames[2:7])
        assert got(5, 12) is None and want(5, 12) is None


def test_open_video_other_containers_go_through_cv2(tmp_path):
    cv2 = pytest.importorskip("cv2")
    frames = np.random.default_rng(3).integers(0, 256, size=(6, 48, 64, 3), dtype=np.uint8)
    path = str(tmp_path / "clip.mkv")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (64, 48))
    if not writer.isOpened():
        pytest.skip("cv2 has no video writer backend")
    for f in frames:
        writer.write(np.ascontiguousarray(f[:, :, ::-1]))
    writer.release()
    got, want = open_video(path), j_open_video(path)
    a, b = got(1, 4), want(1, 4)
    assert a.shape == (3, 48, 64, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert got(4, 9) is None and want(4, 9) is None
