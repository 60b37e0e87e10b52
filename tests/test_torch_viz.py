"""The port's eval-video compositor and writer (``env/viz.py``, numpy
only) against the JAX package's (OpenCV). Exact: the palette, the 256
JET entries (against ``cv2.applyColorMap``), the colorizers, nearest and
bilinear resizes (against ``cv2.resize``; the bilinear panels are held
within 1 of JAX's, though OpenCV's fixed point is reproduced bit for
bit here), the filled circle (``cv2.circle``), ``draw_collision``,
``top_down_view`` on a FakeSim, and every frame pixel outside the text
band and the legend's label boxes. The port draws its own 5x7 glyphs
there: the band is white except where the text lies, and dark there. The
PNG directory equals JAX's codec-less output in path and names, and
decodes (``cv2.imread``) to the frames written; the tensorboard option
hands the writer JAX's tensor, step and fps."""
import os

import cv2
import numpy as np
import pytest

import ws_mgmap_tpu.env.viz as jviz
from ws_mgmap_tpu.env.sim import FakeSim as JFakeSim
from ws_mgmap_tpu_torch.env import viz
from ws_mgmap_tpu_torch.env.sim import FakeSim
from ws_mgmap_tpu_torch.utils.geometry import quat_from_yaw

PANEL_TOL = 1      # the bilinear panels (rgb, heatmap), uint8 levels
LABEL_X = 26       # the legend's label boxes: its columns from x = 26
TILE = 240
TEXT = "walk past the sofa, turn left at the kitchen and stop by the stairs"


def _obs(rng, semantic=True, gt_map=False):
    obs = {"rgb": rng.uniform(-20, 275, (224, 224, 3)).astype(np.float32)}
    if semantic:
        obs["semantic_filter"] = np.eye(27, dtype=np.float32)[
            rng.randint(0, 27, (224, 224))]
    if gt_map:
        obs["gt_semantic_map"] = rng.randint(0, 27, (100, 100))
    return obs


def _layout(obs, pred, att):
    """The panels JAX's compositor lays out: (name, width) in order."""
    out = [("rgb", TILE)]
    if "semantic_filter" in obs:
        out.append(("semantic", TILE))
    if pred is not None or "gt_semantic_map" in obs:
        out.append(("map", TILE))
    if att is not None:
        out.append(("heatmap", TILE))
    if pred is not None or "gt_semantic_map" in obs:
        out.append(("legend", 120))
    return out


def _check_frame(got, want, obs, pred, att):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    x = 0
    for name, width in _layout(obs, pred, att):
        g = got[:TILE, x:x + width].astype(np.int64)
        w = want[:TILE, x:x + width].astype(np.int64)
        if name in ("rgb", "heatmap"):
            assert np.abs(g - w).max() <= PANEL_TOL, name
        elif name == "legend":
            np.testing.assert_array_equal(g[:, :LABEL_X], w[:, :LABEL_X])
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
        x += width
    assert x == got.shape[1]


def _check_band(frame, text):
    band = frame[TILE:]
    assert band.shape[0] == 40
    dark = (band < 128).all(-1)
    white = (band == 255).all(-1)
    assert (dark | white).all()
    rows, cols = np.nonzero(dark)
    assert len(rows) > 5 * len(text.replace(" ", ""))
    # the glyphs sit on baseline h + 26, from x = 4, 6 pixels a character
    assert rows.min() >= 26 - 7 and rows.max() <= 26
    assert cols.min() >= 4 and cols.max() < 4 + 6 * len(text[:90])


def test_palette_jet_and_colorizers_exact():
    np.testing.assert_array_equal(viz.PALETTE_27, jviz.PALETTE_27)
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_JET)[:, 0]
    np.testing.assert_array_equal(viz.JET_BGR, lut)
    rng = np.random.RandomState(0)
    sem = rng.randint(-3, 30, (48, 48))
    np.testing.assert_array_equal(viz.colorize_semantic_map(sem),
                                  jviz.colorize_semantic_map(sem))
    for att in (rng.rand(576).astype(np.float32), rng.randn(24, 24),
                np.full(576, 0.5, np.float32), rng.rand(100)):
        np.testing.assert_array_equal(viz.colorize_heatmap(att),
                                      jviz.colorize_heatmap(att))


@pytest.mark.parametrize("src,dst", [((224, 224), (240, 240)),
                                     ((100, 100), (240, 240)),
                                     ((48, 48), (240, 240)),
                                     ((24, 24), (100, 100)),
                                     ((7, 13), (240, 100)),
                                     ((256, 256), (240, 240))])
def test_resizes_equal_opencv(src, dst):
    rng = np.random.RandomState(sum(src) + sum(dst))
    img = rng.randint(0, 256, src + (3,)).astype(np.uint8)
    np.testing.assert_array_equal(
        viz.resize_nearest(img, dst[::-1]),
        cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST))
    got = viz.resize_linear(img, dst[::-1]).astype(np.int64)
    want = cv2.resize(img, dst[::-1]).astype(np.int64)
    assert np.abs(got - want).max() <= PANEL_TOL


def test_circle_line_collision_and_top_down_exact():
    rng = np.random.RandomState(1)
    for _ in range(300):
        a = rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
        b = a.copy()
        c = (int(rng.randint(-6, 36)), int(rng.randint(-6, 26)))
        r = int(rng.randint(0, 9))
        cv2.circle(a, c, r, (0, 0, 255), -1)
        viz.fill_circle(b, c, r, (0, 0, 255))
        np.testing.assert_array_equal(a, b)
    view = rng.randint(0, 256, (240, 240, 3)).astype(np.uint8)
    np.testing.assert_array_equal(viz.draw_collision(view),
                                  jviz.draw_collision(view))
    for yaw, wp in ((0.3, np.zeros(3)), (-2.9, None), (3.1, [7.9, 0, -7.9])):
        sims = [cls("fake/viz") for cls in (FakeSim, JFakeSim)]
        for s in sims:
            s.reset_agent(s.scene.sample_navigable(np.random.RandomState(2)),
                          quat_from_yaw(yaw))
        np.testing.assert_array_equal(viz.top_down_view(sims[0], wp),
                                      jviz.top_down_view(sims[1], wp))


@pytest.mark.parametrize("collision", [False, True])
@pytest.mark.parametrize("maps", ["none", "pred", "gt", "pred+gt"])
def test_frames_equal_jax(collision, maps):
    rng = np.random.RandomState(3 + collision)
    obs = _obs(rng, semantic=maps != "none", gt_map="gt" in maps)
    pred = (rng.randn(48, 48, 27).astype(np.float32) if "pred" in maps
            else None)
    att = rng.rand(576).astype(np.float32) if maps != "none" else None
    info = {"collisions": {"is_collision": collision}}
    got = viz.observations_to_image(obs, pred_sem_map=pred, att_map=att,
                                    info=info)
    want = jviz.observations_to_image(obs, pred_sem_map=pred, att_map=att,
                                      info=info)
    _check_frame(got, want, obs, pred, att)
    got_t = viz.append_text_to_image(got, TEXT)
    want_t = jviz.append_text_to_image(want, TEXT)
    assert got_t.shape == want_t.shape
    _check_frame(got_t[:TILE], want_t[:TILE], obs, pred, att)
    _check_band(got_t, TEXT)
    # the simulator's top-down panel, as JAX adds it with sim=
    sim, jsim = FakeSim("fake/viz"), JFakeSim("fake/viz")
    with_sim = viz.observations_to_image(obs, sim=sim, info=info)
    np.testing.assert_array_equal(with_sim[:, TILE:2 * TILE],
                                  jviz.top_down_view(jsim, size=TILE))


def _read_png(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_UNCHANGED),
                        cv2.COLOR_BGR2RGB)


def test_png_directory_equals_jax_codecless_output(tmp_path, monkeypatch):
    class NoCodec:
        def __init__(self, *a, **k):
            pass

        def isOpened(self):
            return False

    monkeypatch.setattr(jviz.cv2, "VideoWriter", NoCodec)
    rng = np.random.RandomState(4)
    frames = [viz.append_text_to_image(viz.observations_to_image(
        _obs(rng), pred_sem_map=rng.randn(48, 48, 27).astype(np.float32),
        att_map=rng.rand(576).astype(np.float32)), TEXT) for _ in range(3)]
    frames.append(np.zeros((5, 7, 3), np.uint8))     # sizes may change
    metrics = {"spl": 0.456, "success": 1.0}
    kw = dict(episode_id="ep7", checkpoint_idx=3, metrics=metrics)
    want = jviz.generate_video(str(tmp_path / "jax"), frames, **kw)
    got = viz.generate_video(str(tmp_path / "port"), frames, **kw)
    assert os.path.relpath(got, tmp_path / "port") == os.path.relpath(
        want, tmp_path / "jax") == "episode=ep7-ckpt=3-spl=0.46-success=1.00"
    names = sorted(os.listdir(got))
    assert names == sorted(os.listdir(want)) == [f"{i:05d}.png"
                                                  for i in range(4)]
    for name, frame in zip(names, frames):
        np.testing.assert_array_equal(_read_png(os.path.join(got, name)),
                                      frame)
        np.testing.assert_array_equal(_read_png(os.path.join(want, name)),
                                      frame)
    with pytest.raises(ValueError, match="uint8"):
        viz.encode_png(frames[0].astype(np.float32))
    assert viz.generate_video(str(tmp_path), [], episode_id="e") is None


def test_tensorboard_option_equals_jax(tmp_path):
    class Recorder:
        def __init__(self):
            self.calls = []

        def add_video(self, tag, vid, global_step=None, fps=None):
            self.calls.append((tag, vid.numpy().copy(), global_step, fps))

    frames = [np.full((32, 48, 3), i * 10, np.uint8) for i in range(5)]
    frames[2][3, 4] = (1, 2, 3)
    got_tb, want_tb = Recorder(), Recorder()
    kw = dict(episode_id="7", checkpoint_idx=3,
              video_option=["tensorboard"])
    assert viz.generate_video(str(tmp_path / "p"), frames, tb_writer=got_tb,
                              **kw) is None
    assert jviz.generate_video(str(tmp_path / "j"), frames,
                               tb_writer=want_tb, **kw) is None
    assert not (tmp_path / "p").exists()
    (tag, vid, step, fps), = got_tb.calls
    (jtag, jvid, jstep, jfps), = want_tb.calls
    assert (tag, step, fps) == (jtag, jstep, jfps) == ("episode_7", 3, 10)
    assert vid.dtype == jvid.dtype == np.uint8
    np.testing.assert_array_equal(vid, jvid)
    assert vid.shape == (1, 5, 3, 32, 48)

    class Broken:
        def add_video(self, *a, **k):
            raise RuntimeError("no moviepy")

    out = viz.generate_video(str(tmp_path / "b"), frames, episode_id="7",
                             video_option=["disk", "tensorboard"],
                             tb_writer=Broken())
    assert out is not None and len(os.listdir(out)) == 5
