"""Interactive terminal preview — the reference's orbit-camera UX, headless
(``tpu_path_tracer.preview``; numpy and the port's camera only).

The reference is an interactive browser app: mouse-drag orbits, wheel
zooms, arrow keys pan, and any motion resets the progressive accumulation
(``lib/camera.js:76-133``, ``renderer.js:174-180``).  A render host has no
browser; this module drives the SAME camera methods (``core.camera``) from
raw-terminal keys and paints the progressive framebuffer as ANSI truecolor
half-blocks (one ``▀`` cell = two vertically stacked pixels), so the full
interact -> reset -> re-accumulate loop runs over ssh.

Keys: a/d orbit, w/s zoom, arrows pan (the reference's bindings,
``lib/camera.js:55-74`` sign quirks included), q quits.
"""

from __future__ import annotations

import os
import select
import sys
import time

import numpy as np


def _read_keys(timeout: float):
    """Non-blocking read of pending keypresses (raw mode); decodes arrow
    escape sequences to 'up'/'down'/'left'/'right'."""
    keys = []
    while select.select([sys.stdin], [], [], timeout)[0]:
        timeout = 0.0
        ch = os.read(sys.stdin.fileno(), 1).decode(errors="ignore")
        if ch == "\x1b":
            rest = ""
            while select.select([sys.stdin], [], [], 0.001)[0]:
                rest += os.read(sys.stdin.fileno(), 1).decode(
                    errors="ignore")
                if rest[-1].isalpha():
                    break
            keys.append({"[A": "up", "[B": "down", "[C": "right",
                         "[D": "left"}.get(rest, "esc"))
        else:
            keys.append(ch)
    return keys


def _paint(img: np.ndarray) -> str:
    """uint8 [H, W, 3] -> ANSI truecolor half-block frame (H/2 lines)."""
    h = img.shape[0] - (img.shape[0] % 2)
    top, bot = img[0:h:2], img[1:h:2]
    lines = []
    for t_row, b_row in zip(top, bot):
        cells = [f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m"
                 f"\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
                 for t, b in zip(t_row, b_row)]
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


def run_preview(renderer, max_fps: float = 0.0):
    """Interactive loop: progressive frames + camera keys until 'q'.

    ``renderer``: a ``tpu_path_tracer_torch.renderer.Renderer`` (its camera's
    motion flags drive accumulation reset exactly as in the reference's
    per-frame poll, ``renderer.js:174-180``)."""
    import termios
    import tty

    if not sys.stdin.isatty():
        raise RuntimeError(
            "interactive preview needs a tty (run from a terminal, or "
            "drop --interactive for headless rendering)")
    cam = renderer.camera
    fd = sys.stdin.fileno()
    old_attrs = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    sys.stdout.write("\x1b[2J")  # clear
    try:
        while True:
            t0 = time.perf_counter()
            renderer.step()          # consumes motion flags -> reset
            img = renderer.display()
            sys.stdout.write("\x1b[H" + _paint(img)
                             + f"\n\x1b[0mframe {renderer.frame_num}  "
                             f"[a/d orbit  w/s zoom  arrows pan  q quit]"
                             f"\x1b[K")
            sys.stdout.flush()

            for key in _read_keys(0.001):
                if key == "q":
                    return
                elif key == "a":
                    cam.orbit((0.0, 0.0), (500.0, 0.0))
                elif key == "d":
                    cam.orbit((0.0, 0.0), (-500.0, 0.0))
                elif key == "w":
                    cam.zoom(-1.0)
                elif key == "s":
                    cam.zoom(1.0)
                elif key == "left":
                    cam.move_left()
                elif key == "right":
                    cam.move_right()
                elif key == "up":
                    cam.move_up()
                elif key == "down":
                    cam.move_down()
            # The orbit drag sets `moving` latched; clear it (mouse-up
            # equivalent, lib/camera.js:95-99).  As in the JAX preview this
            # comes before the next frame polls the flag, so an orbit moves
            # the view without restarting the accumulation.
            cam.moving = False

            if max_fps > 0:      # renderer.js:206-209
                budget = 1.0 / max_fps
                dt = time.perf_counter() - t0
                if dt < budget:
                    time.sleep(budget - dt)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old_attrs)
        sys.stdout.write("\x1b[0m\n")
