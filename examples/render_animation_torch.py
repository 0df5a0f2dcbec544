"""Animation demo on the PyTorch/CUDA port: a keyframed orbit around the
black hole.

The cameras are interpolated on the device, every frame renders through
the march and star kernels on a CUDA card (``--device cpu``: their plain
PyTorch versions), and the native PNG pool writes the frames while the
next ones render.

Run:  python examples/render_animation_torch.py --frames 60 -o orbit_frames
then: scripts/ffmpeg-animate orbit_frames/orbit   # -> out.mkv
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("-o", "--out", default="orbit_frames")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args()

    from blackstar_tpu_torch.animation import Animation, Keyframe
    from blackstar_tpu_torch.config import Camera, Scene
    from blackstar_tpu_torch.video import render_animation

    scene = Scene(
        resolution=(args.width, args.width * 9 // 16),
        disk_opacity=0.95,
        disk_inner=1.8,
        disk_outer=13.0,
        bloom_strength=0.15,
        dtype="float32",
    )
    anim = Animation(
        scene=scene,
        n_frames=args.frames,
        interpolation="linear",
        keyframes=[
            Keyframe(Camera((3, 3, -20), (-7, 5, 0), (-0.2, 1, 0), 1.5), 0.0),
            Keyframe(Camera((-8, 2, -20), (3, -1, 0), (-0.2, 1, 0), 1.8), 0.5),
            Keyframe(Camera((-15, 1, -20), (13, -7, 0), (-0.2, 1, 0), 2.0), 1.0),
        ],
    )
    paths = render_animation(
        anim,
        args.out,
        basename="orbit",
        device=args.device,
        progress=lambda i, n: print(f"frame {i}/{n}", end="\r"),
    )
    print(f"\n{len(paths)} frames in {args.out}/")


if __name__ == "__main__":
    main()
