"""copies.h2d (count, program counter; layer ``replay``, moves frame_ms):
copies per frame from the host to the card, at the system's copy sites
(rbench/inside.py ``copies``)."""
from rbench import inside

read = inside.reader("copies.h2d")
