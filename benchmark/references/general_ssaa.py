"""The reference ``general_ssaa``: the general (Blinn-Phong) shader under a
point light, LH/OpenGL perspective, supersampled by 2.

``Scene(supersample=ss)`` renders its frame at ss times the resolution
and box-filters the float frame down by ss (the mean of each ss x ss
block of pixels) before the vertical flip, gamma 0.8 and uint8. This
reference renders the spec at the ss-scaled resolution with every stage
of ``rbench.reference.Reference`` and overrides only the one that
differs: after the base's ``_shade`` the float frame is box-filtered
(:func:`box_filter`), and the base's flip, gamma and uint8 follow. Its
``zbuf``, ``tid`` and ``stencil`` are at the scaled size, as the system
leaves ``last_zbuf``, ``last_tid`` and ``last_stencil``, and
``counts["pixels"]`` counts the pixels inside; ``counts["out_pixels"]``
those of the filtered frame.

Departure from the system's filter: the mean of each block is written as
the sum of the ss * ss strided sub-images (``frame[dy::ss, dx::ss]``, in
row-major order of (dy, dx)) over ss * ss, not as a reshape and a mean
over two dimensions; the two differ in the order of the additions only.

Plain PyTorch, float32 with TF32 off as the configuration states (the
base's ``tf32`` and ``dtype`` give the control and the float64 witness);
it imports nothing of the system under test and nothing of JAX.
"""
import dataclasses

import torch

from rbench.reference import Reference as General

__all__ = ["Reference", "box_filter"]


def box_filter(frame, ss):
    """(H / ss, W / ss, C) mean of each ss x ss block of the (H, W, C)
    ``frame``: the ss * ss strided sub-images summed in (dy, dx) order,
    over ss * ss."""
    total = None
    for dy in range(ss):
        for dx in range(ss):
            sub = frame[dy::ss, dx::ss]
            total = sub if total is None else total + sub
    return total / (ss * ss)


class Reference(General):
    """``rbench.reference.Reference`` at ss times the spec's resolution,
    its float frame box-filtered down by ss before the flip."""

    SUPPORTS = {**General.SUPPORTS, "supersample": 2}

    def __init__(self, spec, device, tf32=False, dtype=torch.float32):
        self.ss = int(spec.settings["supersample"])
        h, w = spec.resolution
        inside = dataclasses.replace(spec,
                                     resolution=(h * self.ss, w * self.ss))
        super().__init__(inside, device, tf32=tf32, dtype=dtype)

    def _shade(self, *args):
        return box_filter(super()._shade(*args), self.ss)

    def render(self, camera, light, maps=None):
        out = super().render(camera, light, maps)
        out.counts["out_pixels"] = out.counts["pixels"] // self.ss ** 2
        return out
