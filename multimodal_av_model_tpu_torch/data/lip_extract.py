"""Offline lip extraction: raw videos -> the per-sentence lip clips that the
corpus reader and K2 consume.

Own copy of ``multimodal_av_model_tpu/data/lip_extract.py:1-286`` (numpy
only; mediapipe gated by ``have_mediapipe``, cv2 only inside
``video_frame_reader``):

* ``detect_lip_boxes``: MediaPipe FaceMesh per frame -> ``[T, 4]`` pixel
  boxes over the 40 lip landmarks plus a 10 px margin;
* ``detect_lip_boxes_heuristic``: the dependency-free localizer (pseudo-hue
  blob, two refinement passes, a width-3 temporal median);
  ``detect_lip_boxes_auto`` takes MediaPipe when it imports, this otherwise;
* ``crop_clip_from_boxes``: crop each frame's box and resize it
  (``data/pipeline.py:_resize_bilinear_np``, cv2 INTER_LINEAR weights);
* ``extract_clips``: the sentence-wise loop over the AI-Hub JSON; a clip
  is saved as ``astype(np.uint8)`` (numpy's truncation) when its maximum is
  above 1.5, and each skipped sentence is recorded with its reason;
* ``video_frame_reader``: a cv2 frame-range reader (``data/avi.py:open_video``
  takes the numpy AVI reader for ``.avi``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

# MediaPipe FaceMesh lip landmark indices (upper+lower lips) — the same set
# the reference selects (reference preprocessing.py:35-40).
LIP_LANDMARK_INDICES = sorted(
    set(
        [61, 146, 91, 181, 84, 17, 314, 405, 321, 375, 291,
         308, 324, 318, 402, 317, 14, 87, 178, 88, 95,
         185, 40, 39, 37, 0, 267, 269, 270, 409, 415,
         310, 311, 312, 13, 82, 81, 42, 183, 78]
    )
)


def have_mediapipe() -> bool:
    try:
        import mediapipe  # noqa: F401

        return True
    except ImportError:
        return False


def lip_box_from_landmarks(
    xs: np.ndarray, ys: np.ndarray, width: int, height: int, margin: int = 10
) -> tuple[int, int, int, int] | None:
    """Pixel bbox over lip landmarks + margin, clamped (reference :69-80).
    Returns ``(x1, y1, x2, y2)`` or None if degenerate."""
    x1 = max(0, int(xs.min()) - margin)
    x2 = min(width, int(xs.max()) + margin)
    y1 = max(0, int(ys.min()) - margin)
    y2 = min(height, int(ys.max()) + margin)
    if x2 <= x1 or y2 <= y1:
        return None
    return x1, y1, x2, y2


def detect_lip_boxes(frames_rgb, margin: int = 10) -> np.ndarray | None:
    """Per-frame lip boxes via MediaPipe FaceMesh; ``[T, 4]`` int32 or None on
    any detection failure (the reference skips the sentence in that case)."""
    import mediapipe as mp

    T, H, W = frames_rgb.shape[0], frames_rgb.shape[1], frames_rgb.shape[2]
    boxes = np.zeros((T, 4), np.int32)
    with mp.solutions.face_mesh.FaceMesh(
        static_image_mode=False, max_num_faces=1, refine_landmarks=True
    ) as mesh:
        for t in range(T):
            result = mesh.process(np.ascontiguousarray(frames_rgb[t]))
            if not result.multi_face_landmarks:
                return None
            lm = result.multi_face_landmarks[0].landmark
            xs = np.array([lm[i].x * W for i in LIP_LANDMARK_INDICES])
            ys = np.array([lm[i].y * H for i in LIP_LANDMARK_INDICES])
            box = lip_box_from_landmarks(xs, ys, W, H, margin)
            if box is None:
                return None
            boxes[t] = box
    return boxes


def _box_blur(img: np.ndarray, k: int = 5) -> np.ndarray:
    """Separable k×k mean filter via cumsum (pure NumPy, O(HW))."""
    if k <= 1:
        return img
    pad = k // 2

    def blur_axis(a, axis):
        a = np.concatenate([
            np.repeat(a.take([0], axis), pad, axis),
            a,
            np.repeat(a.take([-1], axis), pad, axis)], axis)
        c = np.cumsum(a, axis, dtype=np.float64)
        lead = np.take(c, range(k - 1, a.shape[axis]), axis)
        lag = np.concatenate([
            np.zeros_like(np.take(c, [0], axis)),
            np.take(c, range(0, a.shape[axis] - k), axis)], axis)
        return ((lead - lag) / k).astype(np.float32)

    return blur_axis(blur_axis(img.astype(np.float32), 0), 1)


def lip_score_map(frame_rgb: np.ndarray) -> np.ndarray:
    """Per-pixel lip likelihood from color alone (no learned model).

    Lips are the most red-saturated facial region: pseudo-hue r/(r+g) is
    brightness-invariant and ranks lips above skin; subtracting the frame
    median (skin/background dominate it) and gating on chroma (gray pixels
    have meaningless hue) leaves the lips as the top-scoring blob.
    """
    f = np.asarray(frame_rgb, np.float32)
    if f.max() > 1.5:
        f = f / 255.0
    r, g = f[..., 0], f[..., 1]
    ph = r / (r + g + 1e-6)
    chroma = f.max(axis=-1) - f.min(axis=-1)
    s = (ph - np.median(ph)) * np.clip(chroma / 0.15, 0.0, 1.0)
    return _box_blur(np.maximum(s, 0.0), 5)


def detect_lip_boxes_heuristic(
    frames_rgb: np.ndarray, margin: int = 10, sigmas: float = 2.4
) -> np.ndarray | None:
    """First-party lip-box localizer: no MediaPipe, no learned weights.

    Replaces the reference's landmark-detection stage
    (reference preprocessing.py:31-80) with a color-blob estimator good
    enough for the crop-ROI use case (the crop carries a +margin border and
    the downstream encoder is translation-tolerant):

    1. score each pixel with ``lip_score_map``;
    2. keep the top-scoring pixels (adaptive threshold at 60 % of max);
    3. two refinement passes: weighted centroid ± ``sigmas``·σ, each pass
       restricted to the previous window — rejects stray red pixels far
       from the dominant blob;
    4. temporal median filter (width 3) over per-frame boxes — lips move
       slowly at 30 fps, single-frame failures get bridged.

    Returns ``[T, 4]`` int32 ``(x1, y1, x2, y2)`` boxes (+margin, clamped),
    or None if any frame has no usable signal (reference semantics: skip
    the sentence).  Validated on synthetic AVI fixtures with known
    ground-truth lip ellipses (tests/test_torch_lip_extract.py).
    """
    frames_rgb = np.asarray(frames_rgb)
    T, H, W = frames_rgb.shape[:3]
    raw = np.zeros((T, 4), np.float64)
    for t in range(T):
        s = lip_score_map(frames_rgb[t])
        smax = float(s.max())
        if smax <= 1e-6:
            return None
        keep = s >= 0.6 * smax
        ys, xs = np.nonzero(keep)
        w = s[ys, xs]
        for _ in range(2):
            if w.sum() <= 1e-6:
                return None
            cx, cy = np.average(xs, weights=w), np.average(ys, weights=w)
            sx = np.sqrt(np.average((xs - cx) ** 2, weights=w)) + 1.0
            sy = np.sqrt(np.average((ys - cy) ** 2, weights=w)) + 1.0
            inside = ((np.abs(xs - cx) <= sigmas * sx)
                      & (np.abs(ys - cy) <= sigmas * sy))
            xs, ys, w = xs[inside], ys[inside], w[inside]
        raw[t] = (cx - sigmas * sx, cy - sigmas * sy,
                  cx + sigmas * sx, cy + sigmas * sy)
    # Temporal median (width 3) then margin + clamp.
    sm = raw.copy()
    for t in range(T):
        lo, hi = max(0, t - 1), min(T, t + 2)
        sm[t] = np.median(raw[lo:hi], axis=0)
    boxes = np.zeros((T, 4), np.int32)
    for t in range(T):
        x1 = max(0, int(sm[t, 0]) - margin)
        y1 = max(0, int(sm[t, 1]) - margin)
        x2 = min(W, int(np.ceil(sm[t, 2])) + margin)
        y2 = min(H, int(np.ceil(sm[t, 3])) + margin)
        if x2 <= x1 or y2 <= y1:
            return None
        boxes[t] = (x1, y1, x2, y2)
    return boxes


def detect_lip_boxes_auto(frames_rgb, margin: int = 10) -> np.ndarray | None:
    """MediaPipe landmarks when the dependency exists, the first-party
    color-blob localizer otherwise — extraction always executes."""
    if have_mediapipe():
        return detect_lip_boxes(frames_rgb, margin)
    return detect_lip_boxes_heuristic(frames_rgb, margin)


def crop_clip_from_boxes(
    frames: np.ndarray, boxes: np.ndarray, out_size: int = 128
) -> np.ndarray:
    """Crop per-frame boxes and resize to ``out_size`` (reference :85-88 uses
    cv2.resize; we use the same-math native/NumPy bilinear).  ``frames`` is
    ``[T, H, W, C]``; returns ``[T, out, out, C]`` float32."""
    from .pipeline import _resize_bilinear_np

    T = frames.shape[0]
    out = np.empty((T, out_size, out_size, frames.shape[-1]), np.float32)
    for t in range(T):
        x1, y1, x2, y2 = boxes[t]
        crop = np.asarray(frames[t, y1:y2, x1:x2], np.float32)
        # channels-last → resize each channel over (H, W)
        chw = np.moveaxis(crop, -1, 0)
        out[t] = np.moveaxis(_resize_bilinear_np(chw, out_size, out_size), 0, -1)
    return out


@dataclass
class ExtractionResult:
    saved: list
    skipped: list                      # (sentence_id, reason)


def extract_clips(
    frames_for_range,                  # callable (start_frame, end_frame) -> [T,H,W,3] | None
    json_path: str,
    save_dir: str,
    video_name: str,
    fps: int = 30,
    out_size: int = 128,
    margin: int = 10,
    boxes_for_frames=None,             # callable frames -> [T,4] | None; defaults to MediaPipe
    boxes_for_range=None,              # callable (start,end) -> [T,4] | None:
                                       # PRECOMPUTED per-source-frame boxes
                                       # (corpora shipping landmark boxes need
                                       # no MediaPipe at extraction time)
) -> ExtractionResult:
    """Sentence-wise extraction over the AI-Hub schema (reference :9-103)."""
    os.makedirs(save_dir, exist_ok=True)
    with open(json_path, "r", encoding="utf-8") as f:
        payload = json.load(f)
    metadata = payload[0] if isinstance(payload, list) else payload
    detect = boxes_for_frames or (lambda fr: detect_lip_boxes_auto(fr, margin))

    result = ExtractionResult(saved=[], skipped=[])
    for sent in metadata.get("Sentence_info", []):
        sent_id = sent["ID"]
        start = int(sent["start_time"] * fps)
        end = int(sent["end_time"] * fps)
        frames = frames_for_range(start, end)
        if frames is None or len(frames) == 0:
            result.skipped.append((sent_id, "frame_read_failed"))
            continue
        boxes = (boxes_for_range(start, end) if boxes_for_range is not None
                 else detect(frames))
        if boxes is None:
            result.skipped.append((sent_id, "face_not_detected"))
            continue
        clip = crop_clip_from_boxes(frames, boxes, out_size)
        path = os.path.join(save_dir, f"{video_name}_sentence_{sent_id}.npy")
        np.save(path, clip.astype(np.uint8) if clip.max() > 1.5 else clip)
        result.saved.append(path)
    return result


def video_frame_reader(video_path: str):
    """cv2-backed frame-range reader (cv2 imported here, at the call).
    Returns a callable for ``extract_clips``."""
    import cv2

    def read(start: int, end: int):
        cap = cv2.VideoCapture(video_path)
        cap.set(cv2.CAP_PROP_POS_FRAMES, start)
        frames = []
        for _ in range(start, end):
            ok, frame = cap.read()
            if not ok or frame is None:
                cap.release()
                return None
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
        return np.stack(frames) if frames else None

    return read
