"""The frame videos of the port (JAX scripts/generate_video_vis.py; reference
scripts/generate_video_vis.py): each subfolder of RESULT_DIR that holds
optNNN.png frames (the optimize CLIs' --vis 2 panels) becomes one video.

    python -m supnerf_tpu_torch.cli.generate_video_vis RESULT_DIR [--fps 10]

It runs ffmpeg with the JAX script's command line (libx264, yuv420p) into
RESULT_DIR/<name>.mp4; where there is no ffmpeg binary, or it fails, it
writes RESULT_DIR/<name>.gif with the port's GIF writer (utils/gif.py), a
delay of round(100 / fps) centiseconds a frame. (The JAX script's imageio
GIF gets no frame delay: ROADMAP C.20.) It prints which file it wrote.
"""
from __future__ import annotations

import argparse
import glob
import os
import subprocess

from supnerf_tpu_torch.utils.gif import write_gif
from supnerf_tpu_torch.utils.image_io import read_png


def assemble(frames_dir: str, out_base: str, fps: int) -> str:
    """One folder's opt*.png frames -> out_base.mp4 (ffmpeg) or out_base.gif.
    Returns the path written."""
    frames = sorted(glob.glob(os.path.join(frames_dir, "opt*.png")))
    out_mp4 = out_base + ".mp4"
    cmd = ["ffmpeg", "-y", "-framerate", str(fps), "-pattern_type", "glob",
           "-i", os.path.join(frames_dir, "opt*.png"), "-c:v", "libx264", "-pix_fmt", "yuv420p",
           out_mp4]
    try:
        print(" ".join(cmd))
        subprocess.run(cmd, check=True)
        print(f"ffmpeg wrote {out_mp4}")
        return out_mp4
    except (FileNotFoundError, subprocess.CalledProcessError):
        out_gif = out_base + ".gif"
        write_gif(out_gif, [read_png(f, mode="RGB") for f in frames], fps)
        print(f"ffmpeg unavailable -> the GIF writer wrote {out_gif}")
        return out_gif


def main(argv=None):
    """Returns the paths written, one per frame folder."""
    p = argparse.ArgumentParser("supnerf_tpu_torch generate_video_vis")
    p.add_argument("result_dir")
    p.add_argument("--fps", type=int, default=10)
    args = p.parse_args(argv)
    written = []
    for sub in sorted(os.listdir(args.result_dir)):
        d = os.path.join(args.result_dir, sub)
        if not os.path.isdir(d) or not glob.glob(os.path.join(d, "opt*.png")):
            continue
        written.append(assemble(d, os.path.join(args.result_dir, sub), args.fps))
    return written


if __name__ == "__main__":
    main()
