"""copies.d2d (count, program counter; layer ``replay``, moves frame_ms):
copies per frame on the card, at the system's copy sites (rbench/inside.py
``copies``)."""
from rbench import inside

read = inside.reader("copies.d2d")
