"""The frame videos of the port (cli/generate_video_vis.py, utils/gif.py)
against the JAX script (scripts/generate_video_vis.py) on the CPU, the
GIFs decoded by PIL: one video per folder of opt*.png frames, the frame
count, a 100 ms delay a frame at --fps 10 (the JAX script's imageio GIF has
none: ROADMAP C.20), frames of at most 256 colours decoded exactly, other
frames no worse in mean absolute error than JAX's own GIF of the same
frames (a factor of at most 1.25); LZW past a full code table; ffmpeg's
command line equal to the JAX script's where ffmpeg runs. The frames come
from the optimize CLI's --vis 2 at a tiny config and from drawn
gradients."""
import importlib.util
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
from PIL import Image, ImageSequence

import torch_threads  # noqa: F401
from supnerf_tpu_torch.cli import generate_video_vis, optimize
from supnerf_tpu_torch.utils.gif import lzw_encode, write_gif
from supnerf_tpu_torch.utils.image_io import read_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CONFIG = {
    "arch": "supnerf",
    "net_hyperparams": {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32,
                        "pose_shortcut": 1, "pred_wlh": 0},
    "render_im_sz": 8, "n_samples": 8, "in_img_sz": 32, "optimize": {"num_opts": 6},
}
MAE_FACTOR = 1.25


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_video_vis", os.path.join(REPO, "scripts", "generate_video_vis.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _decode(path):
    """(frames as RGB uint8, their durations in ms) of a GIF, by PIL."""
    with Image.open(path) as im:
        frames, durations = [], []
        for fr in ImageSequence.Iterator(im):
            durations.append(fr.info.get("duration"))
            frames.append(np.asarray(fr.convert("RGB")))
    return frames, durations


def _gradients(n, h=96, w=160):
    """n frames: smooth gradients of thousands of colours, every third one
    posterised to 64 colours."""
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        f = np.stack([(xx * 255 / w + 9 * t) % 256, yy * 255 / h,
                      ((xx + yy) * 0.7 + 13 * t) % 256], -1).astype(np.uint8)
        out.append(f // 64 * 64 if t % 3 == 0 else f)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """A results folder: the optimize CLI's --vis 2 panels of 2 objects (6
    iterations each) and a folder of drawn gradient frames, plus a folder
    without frames."""
    root = tmp_path_factory.mktemp("video")
    cfg = root / "tiny.json"
    cfg.write_text(json.dumps(dict(TINY_CONFIG, model_dir=str(root / "no_checkpoint"))))
    run = root / "run"
    optimize.main(["--config_file", str(cfg), "--dataset", "synthetic", "--num_objects", "2",
                   "--batch_size", "2", "--device", "cpu", "--vis", "2",
                   "--save_dir", str(run)])
    os.makedirs(run / "gradients")
    for t, f in enumerate(_gradients(7)):
        write_png(str(run / "gradients" / f"opt{t:03d}.png"), f)
    os.makedirs(run / "empty")
    return run


def test_gifs_match_the_frames(results, tmp_path, monkeypatch, capsys):
    """Without ffmpeg: one GIF per folder of frames, printed; each decodes to
    the folder's frame count, 100 ms a frame; frames of <= 256 colours
    exactly; the others within MAE_FACTOR of the JAX script's imageio GIF,
    which has no delay at all."""
    monkeypatch.setenv("PATH", str(tmp_path))             # no ffmpeg binary
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(results, port_dir)
    shutil.copytree(results, jax_dir)
    written = generate_video_vis.main([str(port_dir), "--fps", "10"])
    folders = sorted(d for d in os.listdir(results) if os.path.isdir(results / d)
                     and any(f.startswith("opt") for f in os.listdir(results / d)))
    assert len(folders) == 3 and "gradients" in folders
    assert written == [str(port_dir / f"{d}.gif") for d in folders]
    out = capsys.readouterr().out
    assert all(f"the GIF writer wrote {p}" in out for p in written)
    _jax_script().main([str(jax_dir), "--fps", "10"])
    n_many = 0
    for d in folders:
        frames = [read_png(str(results / d / f), mode="RGB")
                  for f in sorted(os.listdir(results / d)) if f.startswith("opt")]
        got, durations = _decode(str(port_dir / f"{d}.gif"))
        ref, ref_durations = _decode(str(jax_dir / f"{d}.gif"))
        assert len(got) == len(ref) == len(frames), d
        assert durations == [100] * len(frames), d
        assert not any(ref_durations), d                   # JAX's GIF: no delay (C.20)
        for t, (f, g, r) in enumerate(zip(frames, got, ref)):
            if len(np.unique(f.reshape(-1, 3), axis=0)) <= 256:
                np.testing.assert_array_equal(g, f, err_msg=f"{d} frame {t}")
            else:
                n_many += 1
                mae, ref_mae = (np.abs(x.astype(int) - f.astype(int)).mean() for x in (g, r))
                assert mae <= MAE_FACTOR * ref_mae, (d, t, mae, ref_mae)
    assert n_many >= 4


def test_lzw_past_a_full_code_table(tmp_path):
    """Frames of random indices fill the 4096-code table several times (the
    clear code mid-stream), one colour per frame and a 1 x 1 frame: PIL
    decodes each exactly; --fps 4 gives 250 ms."""
    rng = np.random.default_rng(0)
    palette = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    frames = [palette[rng.integers(0, 256, (120, 200))],
              palette[rng.integers(0, 4, (120, 200))],
              np.full((120, 200, 3), 7, np.uint8)]
    write_gif(str(tmp_path / "a.gif"), frames, 4)
    got, durations = _decode(str(tmp_path / "a.gif"))
    assert durations == [250] * 3
    for f, g in zip(frames, got):
        np.testing.assert_array_equal(g, f)
    write_gif(str(tmp_path / "b.gif"), [np.full((1, 1, 3), 200, np.uint8)], 10)
    np.testing.assert_array_equal(_decode(str(tmp_path / "b.gif"))[0][0], [[[200, 200, 200]]])
    assert len(lzw_encode(np.zeros(5000, np.uint8))) < 200


def test_ffmpeg_first_with_the_jax_command(results, tmp_path, monkeypatch, capsys):
    """Where ffmpeg runs, the port runs the JAX script's exact command line
    and writes no GIF; where it fails, the GIF."""
    calls = []

    def fake_run(cmd, check):
        calls.append(list(cmd))
        if fail:
            raise subprocess.CalledProcessError(1, cmd)

    fail = False
    monkeypatch.setattr(subprocess, "run", fake_run)
    d = str(results / "gradients")
    assert generate_video_vis.assemble(d, str(tmp_path / "g"), 10) == str(tmp_path / "g.mp4")
    _jax_script().assemble(d, str(tmp_path / "g"), 10)
    assert calls[0] == calls[1] and calls[0][0] == "ffmpeg"
    assert not os.path.exists(tmp_path / "g.gif")
    assert f"ffmpeg wrote {tmp_path / 'g.mp4'}" in capsys.readouterr().out
    fail = True
    assert generate_video_vis.assemble(d, str(tmp_path / "g"), 10) == str(tmp_path / "g.gif")
    assert len(_decode(str(tmp_path / "g.gif"))[0]) == 7
