"""Evaluation visualization: frame compositor and video writer.

Port of ``ws_mgmap_tpu/env/viz.py``, which re-provides the reference's
eval-video pipeline (`habitat_extensions/utils.py:131-269` + habitat's
`generate_video`): each frame is rgb | first-person semantics | predicted
27-class semantic map | text->map attention heatmap | class legend, with
the instruction text appended below.

The JAX package draws with OpenCV; the port uses numpy only, with its own
copies of the OpenCV operations it needs: the JET colour map (OpenCV's
table, entry for entry, in the BGR order ``applyColorMap`` returns, which
the JAX frames keep), ``resize`` with ``INTER_NEAREST`` (exact) and the
default ``INTER_LINEAR`` on uint8 (OpenCV's 11-bit fixed-point
arithmetic), a filled ``circle`` and ``line`` (exact). Text is the one
thing that differs: OpenCV's Hershey glyphs are not copied, and the port
draws the instruction and the legend's labels with a 5x7 bitmap font
into the same places. Videos are written as a directory of lossless PNG
frames (the JAX package's output when OpenCV has no MJPG codec): the port
has no JPEG encoder.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from ws_mgmap_tpu_torch.env.sensors import line_pixels

# 27-class palette (label 0 = free space), loosely matching the reference's
# d3-40-colors usage (`habitat_extensions/utils.py:14-128`).
_rng = np.random.RandomState(7)
PALETTE_27 = np.concatenate(
    [np.array([[255, 255, 255]], np.uint8),
     _rng.randint(40, 230, size=(26, 3)).astype(np.uint8)], axis=0)

# zlib level of the PNG frames (see generate_video)
PNG_LEVEL = 6


def _jet_bgr() -> np.ndarray:
    """OpenCV's ``COLORMAP_JET`` as ``applyColorMap`` returns it ([256, 3]
    uint8, B G R): the base map r, g, b(x) = clip(min(4x - 1.5, 4.5 - 4x)),
    clip(min(4x - 0.5, 3.5 - 4x)), clip(min(4x + 0.5, 2.5 - 4x)) at x =
    i/255, in float32, re-sampled by OpenCV's ``interp1`` at its float32
    ``linspace(0, 1, 256)`` (each entry y[i-1] + d (y[i] - y[i-1]) / d in
    float32), then scaled by 255 and rounded half to even."""
    f32 = np.float32
    x = np.arange(256) / 255.0
    base = [np.clip(np.minimum(4 * x + o, 3.0 - o - 4 * x), 0, 1)
            .astype(f32) for o in (0.5, -0.5, -1.5)]   # b, g, r
    step = f32(1) / f32(255)
    xs = np.arange(256).astype(f32) * step
    lo = np.maximum(np.arange(256) - 1, 0)
    hi = np.maximum(np.arange(256), 1)
    d = xs - xs[lo]
    lut = []
    for y in base:
        yi = y[lo] + (d * (y[hi] - y[lo])) / (xs[hi] - xs[lo])
        lut.append(np.clip(np.rint(yi * f32(255)), 0, 255).astype(np.uint8))
    return np.stack(lut, axis=-1)


JET_BGR = _jet_bgr()


# -- OpenCV's resize ----------------------------------------------------------
def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)``, size =
    (width, height): destination pixel x reads source min(floor(x * s),
    n - 1) with s = 1 / (dst / src) in float64."""
    w, h = size
    sh, sw = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))), sw - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))), sh - 1)
    return img[ys.astype(np.int64)[:, None], xs.astype(np.int64)[None, :]]


def _linear_taps(dst: int, src: int, clamp: bool):
    """Source index and 11-bit weights (short) of each destination pixel,
    as OpenCV's ``resize`` computes them for ``INTER_LINEAR``: f =
    float((d + 0.5) * scale - 0.5), s = floor(f), f -= s; along x an index
    past either edge is clamped with f = 0 (``clamp``); the weights are
    rint((1 - f) * 2048) and rint(f * 2048) in float32."""
    f32 = np.float32
    f = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(f32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(f32)
    if clamp:
        edge = (s < 0) | (s >= src - 1)
        f = np.where(edge, f32(0), f)
        s = np.clip(s, 0, src - 1)
    w0 = np.rint((f32(1) - f) * f32(2048)).astype(np.int64)
    w1 = np.rint(f * f32(2048)).astype(np.int64)
    return s, w0, w1


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size)`` (``INTER_LINEAR``) of a uint8 image,
    size = (width, height), in OpenCV's fixed point: each row is
    interpolated along x with 11-bit weights into ints, then two rows are
    blended as ((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2,
    rows clamped at the edges."""
    w, h = size
    sh, sw = img.shape[:2]
    if (w, h) == (sw, sh):
        return img.copy()
    src = img.astype(np.int64)
    sx, a0, a1 = _linear_taps(w, sw, clamp=True)
    sx1 = np.minimum(sx + 1, sw - 1)
    shape = (1, -1) + (1,) * (img.ndim - 2)
    rows = (src[:, sx] * a0.reshape(shape)
            + src[:, sx1] * a1.reshape(shape))          # [sh, w, ...]
    sy, b0, b1 = _linear_taps(h, sh, clamp=False)
    r0 = rows[np.clip(sy, 0, sh - 1)] >> 4
    r1 = rows[np.clip(sy + 1, 0, sh - 1)] >> 4
    shape = (-1,) + (1,) * (img.ndim - 1)
    out = (((b0.reshape(shape) * r0) >> 16) + ((b1.reshape(shape) * r1) >> 16)
           + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


# -- OpenCV's drawing -------------------------------------------------------
def fill_circle(img: np.ndarray, center, radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, -1)`` in place: OpenCV's
    midpoint circle (``drawing.cpp::Circle``), each octant pair filled as
    a horizontal span, clipped to the image."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    color = np.asarray(color, img.dtype)

    def span(y, x0, x1):
        if 0 <= y < h and x1 >= 0 and x0 < w:
            img[y, max(x0, 0):min(x1, w - 1) + 1] = color

    while dx >= dy:
        span(cy - dy, cx - dx, cx + dx)
        span(cy + dy, cx - dx, cx + dx)
        span(cy - dx, cx - dy, cx + dy)
        span(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def draw_line(img: np.ndarray, p1, p2, color) -> None:
    """``cv2.line(img, p1, p2, color, 1)`` in place (``line_pixels``)."""
    h, w = img.shape[:2]
    pts = line_pixels(p1, p2, w, h)
    if pts:
        xs, ys = zip(*pts)
        img[list(ys), list(xs)] = np.asarray(color, img.dtype)


# 5x7 bitmap font for ASCII 32..126: 5 column bytes a glyph, bit 0 the top
# row, bit 7 the descender row (the classic LCD font).
_FONT = bytes.fromhex(
    "000000000000005f00000007000700147f147f14242a7f2a1223130864623649"
    "5620500008070300001c2241000041221c002a1c7f1c2a08083e080800807030"
    "000808080808000060600020100804023e5149453e00427f4000724949494621"
    "41494d331814127f1027454545393c4a49493141211109073649494936464949"
    "291e000014000000403400000008142241141414141400412214080201590906"
    "3e415d594e7c1211127c7f494949363e414141227f4141413e7f494949417f09"
    "0909013e414151737f0808087f00417f41002040413f017f081422417f404040"
    "407f021c027f7f0408107f3e4141413e7f090909063e4151215e7f0919294626"
    "4949493203017f01033f4040403f1f2040201f3f4038403f6314081463030478"
    "04036159494d43007f4141410204081020004141417f04020102044040404040"
    "000307080020545478407f284444383844444428384444287f38545454180008"
    "7e090218a4a49c787f0804047800447d40002040403d007f1028440000417f40"
    "007c047804787c080404783844444438fc1824241818242418fc7c0804040848"
    "5454542404043f44243c4040207c1c2040201c3c4030403c44281028444c9090"
    "907c4464544c440008364100000077000000413608000201020402")
_GLYPH_W, _ADVANCE = 5, 6


def draw_text(img: np.ndarray, text: str, x: int, baseline: int,
              color=(0, 0, 0)) -> None:
    """Draw ``text`` in place with the 5x7 font: glyph rows 0-6 end just
    above ``baseline``, descenders on it, 6 pixels a character from ``x``;
    characters outside ASCII 32-126 draw as '?'; clipped to the image."""
    h, w = img.shape[:2]
    color = np.asarray(color, img.dtype)
    for k, ch in enumerate(text):
        code = ord(ch) if 32 <= ord(ch) <= 126 else ord("?")
        cols = _FONT[(code - 32) * _GLYPH_W:(code - 31) * _GLYPH_W]
        x0 = x + k * _ADVANCE
        for c, bits in enumerate(cols):
            for r in range(8):
                px, py = x0 + c, baseline - 7 + r
                if bits >> r & 1 and 0 <= px < w and 0 <= py < h:
                    img[py, px] = color


# -- the compositor ---------------------------------------------------------
def colorize_semantic_map(sem: np.ndarray, num_classes: int = 27) -> np.ndarray:
    """[H, W] int labels -> [H, W, 3] uint8."""
    sem = np.clip(np.asarray(sem, np.int64), 0, num_classes - 1)
    return PALETTE_27[sem]


def colorize_heatmap(att: np.ndarray, out_hw=(100, 100)) -> np.ndarray:
    """Attention vector [S] (or [h,w]) -> JET heatmap image (B G R, as
    OpenCV's ``applyColorMap`` gives it to the JAX package)."""
    a = np.asarray(att, np.float32)
    if a.ndim == 1:
        s = int(round(len(a) ** 0.5))
        a = a.reshape(s, s)
    a = (a - a.min()) / max(a.max() - a.min(), 1e-8)
    img = JET_BGR[(a * 255).astype(np.uint8)]
    return resize_nearest(img, out_hw[::-1])


def top_down_view(sim, waypoint_world=None, size: int = 240) -> np.ndarray:
    """Occupancy top-down with agent pose (+ optional waypoint) marked."""
    scene = getattr(sim, "scene", None)
    if scene is None:
        return np.full((size, size, 3), 200, np.uint8)
    occ = scene.occ.astype(np.uint8)
    img = np.where(occ[..., None] > 0, 60, 255).astype(np.uint8)
    img = np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img

    ag = sim.get_agent_state()
    r, c = scene.world_to_cell(ag.position)
    fill_circle(img, (c, r), 3, (0, 0, 255))
    fwd = sim.forward_vector() if hasattr(sim, "forward_vector") else None
    if fwd is not None:
        r2, c2 = scene.world_to_cell(ag.position + 0.6 * fwd)
        draw_line(img, (c, r), (c2, r2), (0, 0, 255))
    if waypoint_world is not None:
        wr, wc = scene.world_to_cell(waypoint_world)
        fill_circle(img, (wc, wr), 3, (255, 0, 0))
    return resize_nearest(img, (size, size))


def append_text_to_image(image: np.ndarray, text: str,
                         band: int = 40) -> np.ndarray:
    """``image`` over a white band of ``band`` rows holding the first 90
    characters of ``text`` at x = 4, baseline h + 26."""
    h, w = image.shape[:2]
    canvas = np.full((h + band, w, 3), 255, np.uint8)
    canvas[:h] = image
    draw_text(canvas, text[:90], 4, h + 26)
    return canvas


def legend_panel(num_classes: int = 27, tile: int = 240,
                 names=None) -> np.ndarray:
    """Class-color legend strip (reference `utils.py` legend panel): a
    swatch a class at x 4-23, its label from x = 28."""
    img = np.full((tile, 120, 3), 255, np.uint8)
    rows = num_classes
    rh = max(tile // rows, 6)
    for i in range(num_classes):
        y0 = i * rh
        if y0 + rh > tile:
            break
        img[y0:y0 + rh - 1, 4:24] = PALETTE_27[i]
        label = str(i) if names is None else str(names[i])[:10]
        draw_text(img, label, 28, y0 + 7)
    return img


def draw_collision(view: np.ndarray, alpha: float = 0.4) -> np.ndarray:
    """Blend a red border band into the egocentric view on collision steps
    (re-provides habitat's `draw_collision`, used by the reference frame
    compositor at `habitat_extensions/utils.py:165-167`)."""
    view = view.copy()
    h, w = view.shape[:2]
    t = max(2, min(h, w) // 20)
    mask = np.zeros((h, w), bool)
    mask[:t] = mask[-t:] = True
    mask[:, :t] = mask[:, -t:] = True
    red = np.array([255, 0, 0], np.float32)
    view[mask] = ((1 - alpha) * view[mask].astype(np.float32)
                  + alpha * red).astype(np.uint8)
    return view


def observations_to_image(
    obs: Dict[str, Any],
    sim=None,
    pred_sem_map: Optional[np.ndarray] = None,
    att_map: Optional[np.ndarray] = None,
    waypoint_world=None,
    tile: int = 240,
    info: Optional[Dict[str, Any]] = None,
) -> np.ndarray:
    """Compose one eval-video frame (reference `utils.py:131-269`)."""
    panels: List[np.ndarray] = []
    rgb = np.asarray(obs["rgb"], np.float32)
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    rgb = resize_linear(rgb, (tile, tile))
    if (info and isinstance(info.get("collisions"), dict)
            and info["collisions"].get("is_collision")):
        rgb = draw_collision(rgb)  # reference `utils.py:165-167`
    panels.append(rgb)
    if sim is not None:
        panels.append(top_down_view(sim, waypoint_world, size=tile))
    if "semantic_filter" in obs:
        # first-person semantic view (27-class one-hot from the
        # SemanticFilterSensor, reference `utils.py` semantic panel)
        sf = np.asarray(obs["semantic_filter"])
        panels.append(resize_nearest(
            colorize_semantic_map(np.argmax(sf, axis=-1)), (tile, tile)))
    if pred_sem_map is not None:
        labels = np.argmax(pred_sem_map, axis=-1) if pred_sem_map.ndim == 3 \
            else pred_sem_map
        panels.append(resize_nearest(colorize_semantic_map(labels),
                                     (tile, tile)))
    elif "gt_semantic_map" in obs:
        panels.append(resize_nearest(
            colorize_semantic_map(obs["gt_semantic_map"]), (tile, tile)))
    if att_map is not None:
        panels.append(resize_linear(colorize_heatmap(att_map), (tile, tile)))
    if pred_sem_map is not None or "gt_semantic_map" in obs:
        panels.append(legend_panel(tile=tile))
    return np.concatenate(panels, axis=1)


# -- the writer -------------------------------------------------------------
def encode_png(frame: np.ndarray, level: int = PNG_LEVEL) -> bytes:
    """A [H, W, 3] uint8 RGB frame as PNG bytes: 8-bit truecolour, every
    row with filter 0 (none), one zlib stream at ``level``."""
    h, w = frame.shape[:2]
    if frame.dtype != np.uint8 or frame.shape != (h, w, 3):
        raise ValueError(f"PNG frames are [H, W, 3] uint8, not "
                         f"{frame.shape} {frame.dtype}")
    rows = np.zeros((h, 1 + 3 * w), np.uint8)
    rows[:, 1:] = frame.reshape(h, 3 * w)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def generate_video(video_dir: str, frames: List[np.ndarray], episode_id: str,
                   checkpoint_idx: int = 0,
                   metrics: Optional[Dict[str, float]] = None,
                   fps: int = 10,
                   video_option: Optional[List[str]] = None,
                   tb_writer=None) -> Optional[str]:
    """Write an episode video per ``video_option``: "tensorboard" ->
    ``tb_writer.add_video`` of the [1, T, C, H, W] uint8 frames (a failure
    there is ignored, as in the reference's habitat ``generate_video``,
    `common_trainer.py:384-396`); "disk" -> the directory
    ``{video_dir}/episode={id}-ckpt={idx}-{metric=value.2f ...}/`` of
    ``{i:05d}.png`` frames, which is returned. The JAX package writes an
    MJPG ``.avi`` there when OpenCV has the codec and this directory when
    it has not; the port has no JPEG encoder and always writes the
    directory."""
    if not frames:
        return None
    video_option = list(video_option or ["disk"])
    metric_str = "-".join(f"{k}={v:.2f}" for k, v in (metrics or {}).items())
    name = f"episode={episode_id}-ckpt={checkpoint_idx}-{metric_str}"
    if "tensorboard" in video_option and tb_writer is not None:
        try:
            import torch

            vid = torch.from_numpy(
                np.stack(frames)).permute(0, 3, 1, 2)[None]  # [1,T,C,H,W]
            tb_writer.add_video(f"episode_{episode_id}", vid,
                                global_step=checkpoint_idx, fps=fps)
        except Exception:
            pass  # tensorboard video needs moviepy; disk still works
    if "disk" not in video_option:
        return None
    frame_dir = os.path.join(video_dir, name)
    os.makedirs(frame_dir, exist_ok=True)
    for i, f in enumerate(frames):
        with open(os.path.join(frame_dir, f"{i:05d}.png"), "wb") as fh:
            fh.write(encode_png(f))
    return frame_dir
