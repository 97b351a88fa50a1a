"""Frame IO helpers: save, compare and display rendered frames.

Counterpart of ``tpu_renderer/utils/image.py``, in numpy. Pillow (and
tkinter for ``show_frame``) are imported inside the functions, so the
package imports without them.
"""
from __future__ import annotations

import numpy as np

__all__ = ["save_frame", "frame_diff", "show_frame"]


def save_frame(frame: np.ndarray, path) -> None:
    """Write an (H, W, 3) uint8 frame as an image file."""
    from PIL import Image

    Image.fromarray(np.asarray(frame)).save(path)


def frame_diff(a: np.ndarray, b: np.ndarray) -> dict:
    """Pixel-difference summary between two uint8 frames (golden tooling)."""
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    diff = np.abs(a - b).max(axis=-1)
    return {
        "identical_frac": float((diff == 0).mean()),
        "within2_frac": float((diff <= 2).mean()),
        "mean_abs": float(np.abs(a - b).mean()),
        "max_abs": int(diff.max()),
    }


def show_frame(frame: np.ndarray, title: str = "tpu_renderer_torch") -> None:
    """Display a frame in a Tk window, like the reference demo
    (main.py:146-159). Falls back to a PIL viewer without a display server."""
    frame = np.asarray(frame)
    try:
        from tkinter import NW, Canvas, Tk

        from PIL import Image, ImageTk

        win = Tk()
        win.title(title)
        height, width = frame.shape[:2]
        win.geometry(f"{width}x{height}")
        canvas = Canvas(win, width=width, height=height)
        canvas.pack()
        img = ImageTk.PhotoImage(image=Image.fromarray(frame))
        canvas.create_image(0, 0, anchor=NW, image=img)
        win.mainloop()
    except Exception:
        from PIL import Image

        Image.fromarray(frame).show(title=title)
