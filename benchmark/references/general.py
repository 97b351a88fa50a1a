"""The reference ``general``: the general (Blinn-Phong) shader under a
point light, LH/OpenGL perspective, no supersampling.

A reference file defines ``Reference(spec, device, tf32=False,
dtype=torch.float32)`` with ``render(camera, light, maps=None)`` returning
an ``rbench.reference.Output``. A reference for other settings subclasses
``rbench.reference.Reference`` in a file of its own, with its
``SUPPORTS``, and overrides the stages that differ.
"""
from rbench.reference import Reference

__all__ = ["Reference"]
