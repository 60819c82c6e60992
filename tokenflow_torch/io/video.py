"""Host-side video/frame IO (OpenCV + PIL; not performance-relevant —
SURVEY.md §2.11 keeps encoding host-side).

The port's own copy of ``tokenflow_tpu/io/video.py`` (same functions,
same files), so the port imports nothing of the JAX package.

Mirrors the reference's conventions (util.py:18-29, 88-96;
preprocess.py:184-196): ``data/{video}/%05d.png`` frame stores, LANCZOS
resizing of square frames to 512x512, .mov rotation workaround, mp4 export.
The reference encodes with libx264 crf=18 preset=slow (util.py:88-96);
``save_video`` reproduces that when PyAV or an ffmpeg binary is available
and falls back to OpenCV mp4v otherwise (frames are also always written as
lossless PNGs, which is what quality metrics consume). The encoder actually
used is recorded in :data:`LAST_ENCODER` and logged into metrics.json by
the profiling layer.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

# name of the encoder used by the most recent save_video call
LAST_ENCODER: str = "none"


def video_to_frames(
    video_path: str,
    out_root: str = "data",
    img_size: tuple[int, int] = (512, 512),
) -> str:
    """Extract mp4/mov to ``{out_root}/{stem}/%05d.png`` at img_size.

    Parity: reference util.py:18-29 (save_video_frames), including the -90
    degree rotation applied to .mov inputs.
    """
    stem = Path(video_path).stem
    out_dir = os.path.join(out_root, stem)
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(video_path)
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        img = Image.fromarray(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        if video_path.endswith(".mov"):
            img = img.rotate(-90, expand=True)
        img = img.resize(img_size, resample=Image.Resampling.LANCZOS)
        img.save(os.path.join(out_dir, f"{i:05d}.png"))
        i += 1
    cap.release()
    if i == 0:
        raise ValueError(f"no frames decoded from {video_path}")
    return out_dir


def frame_paths(frames_dir: str, n_frames: int) -> list[str]:
    """%05d.png with %05d.jpg fallback (reference preprocess.py:186-188)."""
    paths = [os.path.join(frames_dir, f"{i:05d}.png") for i in range(n_frames)]
    if not os.path.exists(paths[0]):
        paths = [
            os.path.join(frames_dir, f"{i:05d}.jpg") for i in range(n_frames)
        ]
    if not os.path.exists(paths[0]):
        raise FileNotFoundError(
            f"no frames at {frames_dir}/00000.png or .jpg"
        )
    return paths


def load_frames(
    frames_dir: str, n_frames: int, resize_square: int = 512
) -> np.ndarray:
    """Load frames as float32 (F, H, W, 3) in [0, 1]. Square frames are
    resized to resize_square (reference preprocess.py:191-192)."""
    out = []
    for p in frame_paths(frames_dir, n_frames):
        img = Image.open(p).convert("RGB")
        if img.size[0] == img.size[1] and img.size[0] != resize_square:
            img = img.resize(
                (resize_square, resize_square),
                resample=Image.Resampling.LANCZOS,
            )
        out.append(np.asarray(img, np.float32) / 255.0)
    return np.stack(out)


def save_frames(frames: np.ndarray, out_dir: str) -> None:
    """float (F, H, W, 3) in [0,1] -> %05d.png."""
    os.makedirs(out_dir, exist_ok=True)
    for i, f in enumerate(np.clip(frames, 0.0, 1.0)):
        Image.fromarray((f * 255).round().astype(np.uint8)).save(
            os.path.join(out_dir, f"{i:05d}.png")
        )


def _save_video_av(rgb: np.ndarray, save_path: str, fps: int) -> bool:
    """libx264 crf=18 preset=slow via PyAV (the reference encoder,
    util.py:88-96). Returns False if PyAV is unavailable."""
    try:
        import av
    except ImportError:
        return False
    container = av.open(save_path, mode="w")
    stream = container.add_stream("libx264", rate=fps)
    stream.height, stream.width = rgb.shape[1], rgb.shape[2]
    stream.pix_fmt = "yuv420p"
    stream.options = {"crf": "18", "preset": "slow"}
    for frame in rgb:
        for packet in stream.encode(
            av.VideoFrame.from_ndarray(frame, format="rgb24")
        ):
            container.mux(packet)
    for packet in stream.encode():
        container.mux(packet)
    container.close()
    return True


def _save_video_ffmpeg(rgb: np.ndarray, save_path: str, fps: int) -> bool:
    """libx264 crf=18 preset=slow via an ffmpeg binary on PATH."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        return False
    f, h, w, _ = rgb.shape
    proc = subprocess.run(
        [
            ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
            "-s", f"{w}x{h}", "-r", str(fps), "-i", "-",
            "-c:v", "libx264", "-crf", "18", "-preset", "slow",
            "-pix_fmt", "yuv420p", save_path,
        ],
        input=rgb.tobytes(),
        capture_output=True,
    )
    return proc.returncode == 0 and os.path.getsize(save_path) > 0


def save_video(frames: np.ndarray, save_path: str, fps: int = 10) -> None:
    """float (F, H, W, 3) in [0,1] -> mp4.

    Encoder preference: PyAV libx264 (exact reference settings) -> ffmpeg
    binary libx264 -> OpenCV mp4v fallback. Sets :data:`LAST_ENCODER`.
    """
    global LAST_ENCODER
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    rgb = (np.clip(frames, 0.0, 1.0) * 255).round().astype(np.uint8)
    try:
        if _save_video_av(rgb, save_path, fps):
            LAST_ENCODER = "libx264-av-crf18-slow"
            return
    except Exception:
        pass
    try:
        if _save_video_ffmpeg(rgb, save_path, fps):
            LAST_ENCODER = "libx264-ffmpeg-crf18-slow"
            return
    except Exception:
        pass
    f, h, w, _ = rgb.shape
    writer = cv2.VideoWriter(
        save_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    if not writer.isOpened():
        raise RuntimeError(f"cannot open video writer for {save_path}")
    for frame in rgb:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()
    LAST_ENCODER = "mp4v-opencv"
